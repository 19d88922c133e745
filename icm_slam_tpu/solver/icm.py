"""ICM outer loop: init sweep + N refinement sweeps + map filtering.

Equivalent of the reference __main__ pipeline (ICM_ROS.py:280-316): causal
initialization, then N offline sweeps, with per-iteration map-change metrics
(calc_cambio semantics, ICM_SLAM.py:490-495).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.core.energy import weights
from icm_slam_tpu.core.geometry import beam_angles, beams_to_world
from icm_slam_tpu.data.datasets import Dataset
from icm_slam_tpu.frontend.scan_filter import filter_scans, preprocess_ranges
from icm_slam_tpu.mapping.landmark_map import (MapState, filter_map,
                                               seed_from_clusters)
from icm_slam_tpu.solver.sweeps import (SweepData, init_sweep,
                                        refine_sweep_batched,
                                        refine_sweep_sequential)


def first_frame_labels(pts: np.ndarray, dist_thr: float,
                       criterion: str = "inconsistent") -> np.ndarray:
    """Host-side hierarchical clustering of the very first frame's points.

    The reference seeds the map by single-linkage clustering with scipy's
    default 'inconsistent' criterion (ICM_SLAM.py:161).  This runs exactly
    once per dataset, on <= B points, so it stays on the host.
    """
    if pts.shape[0] == 0:
        return np.zeros((0,), np.int32)
    if pts.shape[0] == 1:
        return np.zeros((1,), np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import pdist
    return (fcluster(linkage(pdist(pts)), dist_thr, criterion=criterion)
            - 1).astype(np.int32)


@dataclasses.dataclass
class ICMResult:
    x_init: np.ndarray          # (T, 3) poses after iteration 0
    x: np.ndarray               # (T, 3) refined poses
    map_pos: np.ndarray         # (K, 2) live landmarks
    map_counts: np.ndarray      # (K,)
    changes: np.ndarray         # (N, 3) min/max/mean map change per iter
    timings: dict


def resolve_config(config: ICMConfig, data) -> ICMConfig:
    """Apply the data-dependent config resolution + safety guards.

    Every driver that feeds ``data`` into the batched sweeps (run(), resume,
    bench.py, benchmarks/, the online engine) must pass its config through
    here — the batched paths have two exactness PRECONDITIONS that depend on
    the dataset:

    * beam compaction is exact only when ``obs_cap`` >= the dataset's max
      per-frame valid-beam count (solver.sweeps.compact_data). obs_cap == 0
      resolves to that bound automatically; a user-supplied smaller value is
      an error (it would silently drop real observations).
    * the fast running-mean path of batched_associate only searches the
      first ``map_run_cap`` landmark columns; that is exact only while the
      frozen map's live count stays below the cap.  Live landmarks are
      bounded by total_obs / cota (each needs >= cota observations to
      survive filtering), so the cap is disabled whenever that bound
      reaches it.
    """
    from icm_slam_tpu.solver.sweeps import auto_obs_cap
    if config.obs_cap:
        # a user-supplied cap is validated in EVERY mode: beam compaction
        # also runs in the init sweeps (sequential and batched), so a
        # sequential-mode config with a small obs_cap would otherwise
        # silently drop real observations there
        cap_needed = auto_obs_cap(data.mask)
        if config.obs_cap < cap_needed:
            raise ValueError(
                f"obs_cap={config.obs_cap} is below this dataset's max "
                f"per-frame valid-beam count ({cap_needed}); beam "
                f"compaction would silently drop real observations. "
                f"Use obs_cap=0 (auto) or >= {cap_needed}.")
    elif config.sweep_mode in ("batched", "windowed_ba", "ba"):
        config = dataclasses.replace(config,
                                     obs_cap=auto_obs_cap(data.mask))
    if config.map_run_cap and config.map_run_cap_checked:
        # user vouches for the cap; runtime witnesses verify it (the kept-
        # landmark count of every sweep is checked in check_witness) — keep
        # it as-is, only drop it when it can't buy anything
        if config.map_run_cap >= config.L:
            config = dataclasses.replace(config, map_run_cap=0)
    elif config.map_run_cap:
        live_bound = float(np.asarray(data.mask.sum())) / max(config.cota, 1.0)
        if live_bound + 1 >= config.map_run_cap:
            config = dataclasses.replace(config, map_run_cap=0)
        else:
            # shrink to the tightest 128-aligned width above the bound:
            # exactness needs only nact < cap, and live landmarks can never
            # exceed total_obs / cota.  Halving 256 -> 128 halves the
            # K-step sequential relabel loop in filter_map and every
            # cap-wide segment-sum.
            align = 128
            tight = max(align, -(-int(live_bound + 2) // align) * align)
            if tight < config.map_run_cap:
                config = dataclasses.replace(config, map_run_cap=tight)
    return config


def check_table_overflow(raw_nact, L: int, where: str = "sweep") -> None:
    """Raise if a sweep allocated labels past the landmark table capacity.

    ``raw_nact`` is the PRE-filter live count returned by the sweep (old
    count + newly allocated labels).  Labels >= L alias the discard slot —
    their observations are silently dropped (mapping.landmark_map
    allocate_new_labels / solver.sweeps.batched_associate) — so a raw count
    past L means the run is corrupt, not just full.
    """
    n = int(raw_nact)
    if n > L:
        raise RuntimeError(
            f"landmark table overflow in {where}: {n} labels allocated "
            f"but the table holds L={L}. Observations past the capacity "
            f"were silently discarded; rerun with a larger config.L "
            f"(or a higher cota / dist_thr to create fewer landmarks).")


def kept_count(state: MapState, cota) -> jnp.ndarray:
    """Landmarks that survive the cota prune (pre-merge), on-device.

    This is the quantity every map_run_cap fast path depends on: the
    association slice needs the NEXT sweep's frozen-map live count (==
    post-merge count <= this) under the cap, and filter_map's live_cap
    slice is exact iff this count fits in the slice.  Witnessed per sweep
    so the checked-cap mode (config.map_run_cap_checked) is exact-or-error.
    """
    L = state.pos.shape[0]
    live = jnp.arange(L) < state.nact
    return jnp.sum(live & (state.counts >= cota)).astype(jnp.int32)


def _init_merge_cap(config: ICMConfig) -> int:
    """The init-witness merge cap to enforce: nonzero only when the batched
    init ran AND its final duplicate merge was cap-sliced."""
    if not use_batched_init(config):
        return 0
    from icm_slam_tpu.solver.sweeps import resolve_init_merge_cap
    return resolve_init_merge_cap(config)


def check_witness(witness, config: ICMConfig, where: str = "sweep",
                  init_merge_cap: int = 0) -> None:
    """Host-side validation of a sweep's [raw_nact, kept_count] witness.

    ``init_merge_cap``: nonzero for the batched init's witness when its
    final duplicate merge was cap-sliced (sweeps.resolve_init_merge_cap) —
    that merge runs at cota=0, so EVERY allocated label must fit in the
    cap for it to be exact."""
    w = np.asarray(witness)
    check_table_overflow(w[0], config.L, where)
    if init_merge_cap and int(w[0]) > init_merge_cap:
        raise RuntimeError(
            f"cap-sliced init merge violated in {where}: {int(w[0])} labels "
            f"were allocated but the duplicate merge only covered the "
            f"first init_merge_cap={init_merge_cap} columns — landmark "
            f"mass past the cap was silently dropped. Rerun with "
            f"init_merge_cap=0 (full-width merge) or a larger cap.")
    cap = config.map_run_cap
    if cap and int(w[1]) >= cap:
        raise RuntimeError(
            f"map_run_cap violated in {where}: {int(w[1])} landmarks "
            f"survive the cota prune but the fast paths only track "
            f"map_run_cap={cap} columns — results past this point would "
            f"be silently wrong. Rerun with a larger map_run_cap or "
            f"map_run_cap=0 (exact full-width paths).")


def prepare(dataset: Dataset, config: ICMConfig, dtype=None) -> SweepData:
    """Preprocess + batch-filter the whole dataset into fixed-shape arrays."""
    dtype = dtype or jnp.dtype(config.dtype)
    scans = jnp.asarray(dataset.scans, dtype)
    ranges = preprocess_ranges(scans, config.rango_laser_max, config.radio)
    dist, mask = filter_scans(ranges, config.rango_laser_max, config.dist_thr,
                              dataset.n_beams, config.beam_step_deg,
                              config.beam0_deg)
    ang = beam_angles(dataset.n_beams, config.beam_step_deg, config.beam0_deg,
                      dtype)
    return SweepData(dist=dist, mask=mask, ang=ang,
                     odom=jnp.asarray(dataset.odom, dtype),
                     u=jnp.asarray(dataset.u, dtype))


def seed_map(data: SweepData, x0, config: ICMConfig) -> MapState:
    """Cluster frame 0 on the host and seed the landmark table."""
    if np.ndim(data.ang) != 1:
        raise ValueError(
            "seed_map needs RAW SweepData (shared 1-D beam angles); got "
            "per-frame 2-D ang — hoist_compaction output is only for the "
            "refine paths")
    pts = np.asarray(beams_to_world(x0, data.dist[0], data.ang))
    mask0 = np.asarray(data.mask[0])
    pts_valid = pts[mask0]
    labels = first_frame_labels(pts_valid, config.dist_thr)
    L = config.L
    if pts_valid.shape[0] == 0:
        from icm_slam_tpu.mapping.landmark_map import empty_map
        return empty_map(L, data.dist.dtype)
    return seed_from_clusters(L, pts_valid, labels, data.dist.dtype)


def use_batched_init(config: ICMConfig) -> bool:
    """Iteration-0 engine choice (host-side, config-static).

    The batched Picard init requires the default unicycle kinematics (its
    dead-reckon fill encodes them) and the one-new-label-per-frame quirk;
    outside those, or when the user pins ``init_mode="sequential"``, the
    faithful causal scan runs instead.
    """
    if config.init_mode == "sequential":
        return False
    if config.init_mode == "batched":
        return True
    return (config.sweep_mode != "sequential"
            and config.replicate_new_obs_quirk and config.model is None)


@functools.partial(jax.jit, static_argnames=("config",))
def _init_jit(data, seed, x0, config):
    """Iteration-0 sweep. Returns (map_state, poses, raw_nact).

    ``raw_nact`` is the raw allocated-label count BEFORE any in-sweep merge
    — the only value check_table_overflow can trust (the batched init's
    duplicate merge compacts state.nact to <= L, which would mask an
    overflow where observations were silently dropped).
    """
    from icm_slam_tpu.solver.sweeps import init_sweep_batched
    if use_batched_init(config):
        return init_sweep_batched(data, seed, x0, config, weights(config))
    return init_sweep(data, seed, x0, config, weights(config))


def _refine_step(data, old_map, x, config):
    """One ICM refinement iteration + map filtering (traceable body).

    Returns (filtered map, poses, witness) with witness = int32
    [raw pre-filter live count, kept-after-prune count]: the first is the
    table-overflow witness (> L means labels aliased the discard slot),
    the second the map_run_cap witness (>= cap means the fast cap-sliced
    paths were inexact) — both validated host-side by check_witness.
    """
    w = weights(config)
    if config.sweep_mode == "sequential":
        state, x = refine_sweep_sequential(data, old_map, x, config, w)
    elif config.sweep_mode == "ba":
        from icm_slam_tpu.models.bundle_adjustment import ba_refine
        state, x = ba_refine(data, old_map, x, config, w,
                             gn_iters=config.ba_gn_iters,
                             cg_iters=config.ba_cg_iters)
    elif config.sweep_mode == "windowed_ba":
        from icm_slam_tpu.models.windowed_ba import windowed_ba_refine
        state, x = windowed_ba_refine(data, old_map, x, config, w,
                                      window=config.ba_window)
    else:
        state, x = refine_sweep_batched(data, old_map, x, config, w)
    # the same provable live bound that enables map_run_cap (resolve_config)
    # bounds the kept-landmark count, so the filter's merge machinery can
    # run on the cap-sized slice
    with jax.named_scope("filter_map"):
        filtered = filter_map(state, config.cota, config.dist_thr,
                              live_cap=config.map_run_cap)
    witness = jnp.stack([state.nact.astype(jnp.int32),
                         kept_count(state, config.cota)])
    return filtered, x, witness


_refine_jit = functools.partial(jax.jit, static_argnames=("config",))(
    _refine_step)


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_jit(data, cap):
    from icm_slam_tpu.solver.sweeps import compact_data
    return compact_data(data, cap)


def _compaction_cap(data: SweepData, config: ICMConfig) -> int:
    """Beam-compaction budget when it applies to ``data``, else 0.

    The single eligibility predicate shared by hoist_compaction and the
    in-loop hoist in _refine_loop_jit — sequential mode keeps the shared
    1-D beam vector and is excluded; already-compacted data (B == cap)
    returns 0 so every hoist is idempotent.
    """
    if config.sweep_mode == "sequential":
        return 0
    cap = config.obs_cap or 0
    return cap if cap and cap < data.dist.shape[1] else 0


def hoist_compaction(data: SweepData, config: ICMConfig) -> SweepData:
    """Pre-compact beams ONCE for the non-sequential refinement paths.

    The per-frame validity argsort in compact_data is loop-invariant;
    `_refine_loop_jit` hoists it internally, but the per-iteration
    observer paths (run() with callback/verbose, OnlineSLAM.finish
    verbose, the stress benchmark) call `_refine_jit` per sweep, which
    would re-run the (T, B) sort EVERY sweep.
    The in-sweep guard (cap < B) no-ops on pre-compacted data, so this
    is exact FOR THE REFINE PATHS (_refine_jit / _refine_loop_jit /
    refine_sweep_batched / the BA backends).  The result has per-frame
    2-D ``ang`` — the 1-D-ang consumers (seed_map, the init sweeps,
    loop-closure detect) must keep getting the RAW data.
    """
    cap = _compaction_cap(data, config)
    return _compact_jit(data, cap) if cap else data


@functools.partial(jax.jit, static_argnames=("config",))
def _filter_jit(state, config):
    return filter_map(state, config.cota, config.dist_thr,
                      live_cap=config.map_run_cap)


@functools.partial(jax.jit,
                   static_argnames=("config", "n_iters", "with_metrics"))
def _refine_loop_jit(data, cur_map, x, config, n_iters, with_metrics=True):
    """``n_iters`` refinement iterations fused into ONE device program.

    Each per-iteration `_refine_jit` call pays a host->device dispatch;
    a `lax.scan` over iterations keeps the whole refinement loop
    on-device.  Returns (final map, poses, per-iteration
    witnesses (n_iters, 2) [raw live count, kept-after-prune count],
    per-iteration map_change rows (n_iters, 3)) — the same overflow/cap
    witnesses and convergence metrics the unfused loop collects,
    computed on-device.

    ``with_metrics=False`` skips the per-iteration L×L map_change matrix
    (changes come back as zeros); benchmarks that define throughput as
    pure sweep time use False.
    """
    # hoist beam compaction out of the scan: the per-frame validity
    # argsort is loop-invariant, but XLA does not move sorts out of while
    # bodies — compacting here runs it once per loop, not once per sweep.
    # (The in-sweep compaction no-ops on pre-compacted data: its
    # cap < B guard sees B == cap.)
    cap = _compaction_cap(data, config)
    if cap:
        from icm_slam_tpu.solver.sweeps import compact_data
        data = compact_data(data, cap)

    def body(carry, _):
        cur_map, x = carry
        filtered, x, witness = _refine_step(data, cur_map, x, config)
        chg = (map_change(filtered, cur_map, live_cap=config.map_run_cap)
               if with_metrics else jnp.zeros((3,), x.dtype))
        return (filtered, x), (witness, chg)

    (cur_map, x), (witnesses, changes) = jax.lax.scan(
        body, (cur_map, x), None, length=n_iters)
    return cur_map, x, witnesses, changes


@functools.partial(jax.jit, static_argnames=("live_cap",))
def map_change(new_map: MapState, old_map: MapState, live_cap: int = 0):
    """min/max/mean nearest-landmark displacement (ICM_SLAM.py:490-495).

    ``live_cap`` (static, > 0): compute on the first K rows only — exact
    when both maps' live counts fit (both are post-filter maps, so the
    same witness that guards map_run_cap guards this K×K slice vs L×L).
    """
    L = new_map.pos.shape[0]
    K = live_cap if 0 < live_cap < L else L
    live_new = jnp.arange(K) < new_map.nact
    live_old = jnp.arange(K) < old_map.nact
    d = jnp.linalg.norm(old_map.pos[:K, None, :] - new_map.pos[None, :K, :],
                        axis=-1)
    d = jnp.where(live_old[:, None] & live_new[None, :], d, jnp.inf)
    md = jnp.min(d, axis=0)
    # masked reductions (not nan-ops): an all-masked slice must not poison
    # the metrics — an EMPTY map (either side) yields zeros instead of NaN
    # (reachable on degenerate/fuzz worlds where no landmark survives cota)
    mn = jnp.min(jnp.where(live_new, md, jnp.inf))
    mx = jnp.max(jnp.where(live_new, md, -jnp.inf))
    mean = (jnp.sum(jnp.where(live_new, md, 0.0))
            / jnp.maximum(jnp.sum(live_new), 1))
    stats = jnp.stack([mn, mx, mean]).astype(d.dtype)
    empty = (new_map.nact == 0) | (old_map.nact == 0)
    return jnp.where(empty, jnp.zeros((3,), d.dtype), stats)


def run(dataset: Dataset, config: ICMConfig, n_iters: Optional[int] = None,
        verbose: bool = False, callback=None, on_init=None,
        callback_stride: int = 1) -> ICMResult:
    """Full pipeline: init + N ICM iterations.

    ``on_init(x_init)`` fires right after the init sweep (before any
    refinement) so callers can persist the iteration-0 trajectory even if
    the refinement loop later crashes.

    ``callback_stride > 1`` runs the refinement as ceil(N/stride) FUSED
    segments (each one device program via ``_refine_loop_jit``) and fires
    ``callback(k, cur_map, x)`` only at segment boundaries (k = the last
    completed iteration index).  This keeps the one-program throughput —
    the per-iteration observer path pays one host dispatch per sweep —
    at the cost of observer granularity; per-iteration map-change metrics
    and witnesses are still collected on-device inside each segment.
    """
    n_iters = config.N if n_iters is None else n_iters
    timings = {}

    t0 = time.perf_counter()
    data = prepare(dataset, config)
    config = resolve_config(config, data)
    x0 = jnp.asarray(dataset.x0, data.dist.dtype)
    seed = seed_map(data, x0, config)
    jax.block_until_ready(seed)
    timings["prepare_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, x, raw_nact = _init_jit(data, seed, x0, config)
    cur_map = _filter_jit(state, config)
    jax.block_until_ready(x)
    timings["init_s"] = time.perf_counter() - t0
    check_witness(jnp.stack([raw_nact.astype(jnp.int32),
                             kept_count(state, config.cota)]),
                  config, "init sweep",
                  init_merge_cap=_init_merge_cap(config))
    x_init = np.asarray(x)
    if on_init is not None:
        on_init(x_init)

    # loop-invariant beam compaction, hoisted out of the per-iteration
    # paths (the fused loop's internal hoist no-ops on the result);
    # timed into its own bucket so _compact_jit's first-process compile
    # is not attributed to init or refine
    t0 = time.perf_counter()
    data = hoist_compaction(data, config)
    jax.block_until_ready(data.dist)
    timings["hoist_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if callback is None and not verbose:
        # no per-iteration observer -> fuse the whole refinement loop
        # into one device program (no per-iteration host dispatch)
        cur_map, x, witnesses, changes = _refine_loop_jit(
            data, cur_map, x, config, n_iters)
        jax.block_until_ready(x)
        witnesses = list(np.asarray(witnesses)) if n_iters else []
        changes = np.asarray(changes).tolist()
    elif callback is not None and callback_stride > 1 and not verbose:
        # segmented fused loop: observer fires every `stride` iterations,
        # each segment is one device program (checkpointing does not
        # forfeit the fused path)
        witnesses, changes = [], []
        k = 0
        while k < n_iters:
            seg = min(callback_stride, n_iters - k)
            cur_map, x, wit, chg = _refine_loop_jit(data, cur_map, x,
                                                    config, seg)
            wit = list(np.asarray(wit))
            # validate THIS segment before the observer persists anything:
            # a table-overflow segment must raise here, not after the
            # callback has already checkpointed silently-wrong state
            for j, w in enumerate(wit):
                check_witness(w, config, f"refinement sweep {k + j}")
            witnesses.extend(wit)
            changes.extend(np.asarray(chg).tolist())
            k += seg
            callback(k - 1, cur_map, x)
        jax.block_until_ready(x)
    else:
        changes = []
        witnesses = []
        for k in range(n_iters):
            prev_map = cur_map
            cur_map, x, witness = _refine_jit(data, prev_map, x, config)
            # device-side metrics; host sync deferred to the loop's end
            changes.append(map_change(cur_map, prev_map,
                                      live_cap=config.map_run_cap))
            witnesses.append(witness)
            if callback is not None:
                # same ordering contract as the segmented path: a bad
                # sweep must raise BEFORE the observer persists anything
                # (the callback already host-syncs, so this costs nothing)
                check_witness(np.asarray(witness), config,
                              f"refinement sweep {k}")
                callback(k, cur_map, x)
            if verbose:
                corr = float(jnp.sum(jnp.linalg.norm(x - x_init, axis=1)))
                print(f"[icm] iter {k + 1}/{n_iters} "
                      f"landmarks={int(cur_map.nact)} correction={corr:.4f}",
                      flush=True)
        changes = [np.asarray(c).tolist() for c in changes]
        jax.block_until_ready(x)
    timings["refine_s"] = time.perf_counter() - t0
    timings["refine_per_iter_s"] = timings["refine_s"] / max(n_iters, 1)
    for k, w in enumerate(witnesses):
        check_witness(w, config, f"refinement sweep {k}")

    nact = int(cur_map.nact)
    return ICMResult(
        x_init=x_init, x=np.asarray(x),
        map_pos=np.asarray(cur_map.pos[:nact]),
        map_counts=np.asarray(cur_map.counts[:nact]),
        changes=np.asarray(changes), timings=timings)


# ---------------------------------------------------------------------------
# fleet mode: W worlds in one device program
# ---------------------------------------------------------------------------

def resolve_fleet_config(config: ICMConfig, datas) -> ICMConfig:
    """Merge the per-world data-dependent resolutions into ONE static config.

    Conservative in both caps: the widest beam cap of any world; the
    association cap only if EVERY world proves one (a single unprovable
    world disables it for the whole batch).  Worlds whose solo
    ``resolve_config`` would pick tighter caps run with the merged (wider)
    ones here — exactness is preserved (both caps are exact for any value
    >= the per-world bound), but f32 reduction widths differ from the solo
    run, so per-world reproduction requires giving ``run()`` this same
    merged config — the cap is marked checked so a re-resolve keeps it.
    Even then the vmapped program may pack lanes differently on capped
    paths (f32 reduction reorder, <= 1e-5); tests/test_fleet.py pins both
    the bitwise uncapped case and the noise-level capped case.
    """
    shapes = {d.dist.shape for d in datas}
    if len(shapes) != 1:
        raise ValueError(f"run_batched needs identical dataset shapes; "
                         f"got {sorted(shapes)}")
    resolved = [resolve_config(config, d) for d in datas]
    obs_cap = max(r.obs_cap for r in resolved)
    caps = [r.map_run_cap for r in resolved]
    run_cap = 0 if any(c == 0 for c in caps) else max(caps)
    # mark the merged cap as checked: re-resolving this config (e.g. a solo
    # run() reproducing one fleet world) must keep the MERGED width, not
    # re-shrink to that world's tighter 128-aligned bound — the per-sweep
    # witnesses already guard the cap at runtime
    return dataclasses.replace(resolved[0], obs_cap=obs_cap,
                               map_run_cap=run_cap,
                               map_run_cap_checked=run_cap > 0)


@functools.partial(jax.jit, static_argnames=("config", "n_iters"))
def _pipeline_batched_jit(datas, seeds, x0s, config, n_iters):
    """vmap of the FULL pipeline (init -> filter -> fused refine loop) over a
    leading world axis, compiled as one program."""

    def one(data, seed, x0):
        state, x_i, raw_nact = _init_jit(data, seed, x0, config)
        # same init witness run() enforces: [raw allocated labels,
        # kept-after-cota count] — the second guards the cap-sliced filter
        init_wit = jnp.stack([raw_nact.astype(jnp.int32),
                              kept_count(state, config.cota)])
        cur_map = _filter_jit(state, config)
        cur_map, x, witnesses, _ = _refine_loop_jit(
            data, cur_map, x_i, config, n_iters, with_metrics=False)
        return cur_map, x_i, x, init_wit, witnesses

    return jax.vmap(one)(datas, seeds, x0s)


def run_batched(datasets, config: ICMConfig,
                n_iters: Optional[int] = None, mesh=None) -> list:
    """Run the full pipeline on W same-shape worlds as ONE device program.

    A single world leaves the device mostly idle through the sweep's
    sequential dependency chain, so W worlds cost well under W times the
    latency of one (benchmarks/fleet_curve.py measures the curve).  This
    entry point is the amortization tool: it vmaps the whole pipeline (init sweep, map filter, fused N-iteration
    refinement loop) over a fleet of trajectories — multi-robot mapping,
    Monte-Carlo noise studies, parameter ensembles over replicated data.
    Per-world results match `run()` to f32 op-reordering noise (gated by
    tests/test_fleet.py).

    ``mesh``: an optional 1-D fleet mesh (parallel.mesh.make_fleet_mesh) —
    worlds are sharded across its devices (data parallelism).  Worlds never
    exchange information, so the partitioned program needs ZERO collectives:
    each device runs its W/n worlds end-to-end locally, and single-device
    fleet scaling multiplies by the device count.  W is
    padded up to a mesh-size multiple by replicating the last world (the
    padded lanes' results are discarded).  Per-world results are gated
    against the unsharded program by tests/test_fleet_sharded.py.

    Requirements: every dataset has identical (T, n_beams) shapes and one
    shared config (the reference semantics per world are unchanged — worlds
    never exchange information).  Witness guards run per world.
    """
    if not datasets:
        return []
    n_iters = config.N if n_iters is None else n_iters
    timings = {}

    t0 = time.perf_counter()
    datas = [prepare(ds, config) for ds in datasets]
    config = resolve_fleet_config(config, datas)

    x0s = [jnp.asarray(ds.x0, datas[0].dist.dtype) for ds in datasets]
    seeds = [seed_map(d, x0, config) for d, x0 in zip(datas, x0s)]
    stack = lambda leaves: jax.tree.map(lambda *ls: jnp.stack(ls), *leaves)
    datas_b, seeds_b = stack(datas), stack(seeds)
    x0s_b = jnp.stack(x0s)
    if mesh is not None:
        from icm_slam_tpu.parallel.mesh import put_fleet_sharded
        n_dev = mesh.devices.size
        pad = (-len(datasets)) % n_dev
        if pad:
            rep = lambda a: jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])])
            datas_b = jax.tree.map(rep, datas_b)
            seeds_b = jax.tree.map(rep, seeds_b)
            x0s_b = rep(x0s_b)
        datas_b, seeds_b, x0s_b = put_fleet_sharded(
            mesh, (datas_b, seeds_b, x0s_b))
    jax.block_until_ready(seeds_b)
    timings["prepare_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cur_map, x_init, x, init_wit, witnesses = _pipeline_batched_jit(
        datas_b, seeds_b, x0s_b, config, n_iters)
    jax.block_until_ready(x)
    timings["pipeline_s"] = time.perf_counter() - t0
    timings["per_world_s"] = timings["pipeline_s"] / len(datasets)

    merge_cap = _init_merge_cap(config)
    results = []
    for wdx in range(len(datasets)):
        check_witness(init_wit[wdx], config, f"init sweep (world {wdx})",
                      init_merge_cap=merge_cap)
        for k in range(n_iters):
            check_witness(witnesses[wdx, k], config,
                          f"refinement sweep {k} (world {wdx})")
        nact = int(cur_map.nact[wdx])
        results.append(ICMResult(
            x_init=np.asarray(x_init[wdx]), x=np.asarray(x[wdx]),
            map_pos=np.asarray(cur_map.pos[wdx, :nact]),
            map_counts=np.asarray(cur_map.counts[wdx, :nact]),
            changes=np.zeros((0, 3)), timings=dict(timings)))
    return results
