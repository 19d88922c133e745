"""Guards against the silent-wrongness modes.

Three preconditions of the fast batched paths are now checked instead of
assumed:

* landmark-table overflow: labels >= L alias the discard slot
  (mapping/landmark_map.allocate_new_labels, solver/sweeps
  batched_associate) — run()/resume raise instead of dropping data;
* a user obs_cap below the dataset's max per-frame valid-beam count makes
  beam compaction drop real observations — resolve_config raises;
* map_run_cap must stay above the provable live-landmark bound —
  resolve_config disables it otherwise (every driver routes through it).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver.icm import (check_table_overflow, prepare,
                                     resolve_config, run)


def test_obs_cap_below_dataset_max_raises():
    ds = synthetic_world(T=60, n_landmarks=12, seed=1)
    cfg = ICMConfig(N=1, L=64, cota=3.0, obs_cap=2)
    data = prepare(ds, cfg)
    with pytest.raises(ValueError, match="obs_cap"):
        resolve_config(cfg, data)


def test_obs_cap_auto_resolves():
    ds = synthetic_world(T=60, n_landmarks=12, seed=1)
    cfg = ICMConfig(N=1, L=64, cota=3.0, obs_cap=0)
    data = prepare(ds, cfg)
    out = resolve_config(cfg, data)
    assert out.obs_cap >= int(np.asarray(data.mask.sum(axis=1)).max())


def test_map_run_cap_disabled_when_bound_exceeds_it():
    ds = synthetic_world(T=200, n_landmarks=30, seed=2)
    cfg = ICMConfig(N=1, L=256, cota=1.0, map_run_cap=8)
    data = prepare(ds, cfg)
    out = resolve_config(cfg, data)
    assert out.map_run_cap == 0
    # a cap comfortably above the bound survives
    cfg_hi = dataclasses.replace(cfg, cota=1e9, map_run_cap=8)
    assert resolve_config(cfg_hi, data).map_run_cap == 8


def test_map_run_cap_shrinks_to_bound_and_stays_exact():
    # resolve_config tightens the cap to the smallest 128-aligned width
    # above the live-landmark bound; the shrunk program must produce the
    # SAME refine step as the full-width one (the extra columns are
    # provably dead)
    from icm_slam_tpu.solver.icm import _filter_jit, _init_jit, _refine_jit, \
        seed_map

    ds = synthetic_world(T=300, n_landmarks=20, seed=3)
    cfg = ICMConfig(N=1, L=512, cota=40.0, map_run_cap=256)
    data = prepare(ds, cfg)
    out = resolve_config(cfg, data)
    bound = float(np.asarray(data.mask.sum())) / cfg.cota
    assert bound + 2 <= 128, "fixture must land under one tile"
    assert out.map_run_cap == 128

    wide = dataclasses.replace(out, map_run_cap=256)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, out)
    state, x, raw_nact = _init_jit(data, seed, x0, out)
    m0 = _filter_jit(state, out)
    for c in (out, wide):
        if int(m0.nact) >= c.map_run_cap:
            pytest.skip("fixture violates the cap precondition")
    m_a, x_a, _ = _refine_jit(data, m0, x, out)
    m_b, x_b, _ = _refine_jit(data, m0, x, wide)
    np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_b))
    assert int(m_a.nact) == int(m_b.nact)
    np.testing.assert_array_equal(np.asarray(m_a.pos[:128]),
                                  np.asarray(m_b.pos[:128]))


def test_checked_cap_kept_and_verified():
    # map_run_cap_checked keeps the cap even when the cota bound is loose,
    # runs the fast cap-sliced paths, and the per-sweep witness proves the
    # result equals the full-width program
    from icm_slam_tpu.solver.icm import run as icm_run

    ds = synthetic_world(T=200, n_landmarks=15, seed=7)
    loose = ICMConfig(N=2, L=512, cota=2.0, map_run_cap=128,
                      map_run_cap_checked=True)
    data = prepare(ds, loose)
    rc = resolve_config(loose, data)
    bound = float(np.asarray(data.mask.sum())) / loose.cota
    assert bound > 128, "fixture: the provable bound must be loose"
    assert rc.map_run_cap == 128  # kept, not disabled

    res_checked = icm_run(ds, loose)
    res_full = icm_run(ds, dataclasses.replace(loose, map_run_cap=0,
                                               map_run_cap_checked=False))
    assert res_checked.map_pos.shape == res_full.map_pos.shape
    np.testing.assert_allclose(res_checked.x, res_full.x, atol=1e-5)
    np.testing.assert_allclose(res_checked.map_pos, res_full.map_pos,
                               atol=1e-5)


def test_checked_cap_violation_raises():
    # a world with more surviving landmarks than the checked cap: the
    # witness must trip instead of silently truncating the map
    from icm_slam_tpu.solver.icm import run as icm_run

    ds = synthetic_world(T=300, n_landmarks=60, world_size=60.0, seed=8)
    # (13 landmarks survive on it, against the cap's 8)
    cfg = ICMConfig(N=1, L=512, cota=1.0, map_run_cap=8,
                    map_run_cap_checked=True)
    with pytest.raises(RuntimeError, match="map_run_cap violated"):
        icm_run(ds, cfg)


def test_check_table_overflow_raises():
    with pytest.raises(RuntimeError, match="overflow"):
        check_table_overflow(jnp.asarray(10, jnp.int32), 8, "test sweep")
    check_table_overflow(jnp.asarray(8, jnp.int32), 8, "test sweep")  # ok


def test_sequential_empty_frame0_returns_inputs_unchanged():
    # reference early return (ICM_ROS.py:133-135): an empty frame 0 aborts
    # the sweep and returns (mapa_viejo, x) untouched
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.solver.icm import seed_map
    from icm_slam_tpu.solver.sweeps import refine_sweep_sequential

    ds = synthetic_world(T=40, n_landmarks=10, seed=4)
    cfg = ICMConfig(N=1, L=32, cota=2.0, sweep_mode="sequential")
    data = prepare(ds, cfg)
    data = data._replace(mask=data.mask.at[0].set(False))
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    old_map = seed_map(data._replace(mask=data.mask.at[0, :8].set(True)),
                       x0, cfg)
    x = jnp.asarray(ds.odom, data.dist.dtype)
    state, x_out = refine_sweep_sequential(data, old_map, x, cfg,
                                           weights(cfg))
    np.testing.assert_array_equal(np.asarray(x_out), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(state.pos),
                                  np.asarray(old_map.pos))
    assert int(state.nact) == int(old_map.nact)


def test_padded_empty_last_frame_not_pulled_to_origin():
    # on a padded time axis an empty last REAL frame must
    # average with a clamped neighbour, never with the zero-padded pose
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.solver.icm import seed_map
    from icm_slam_tpu.solver.sweeps import SweepData, refine_sweep_batched

    ds = synthetic_world(T=41, n_landmarks=10, seed=5)
    ds.odom[:, :2] += 10.0  # trajectory far from the origin
    cfg = ICMConfig(N=1, L=32, cota=2.0, map_run_cap=0)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    last_t = data.dist.shape[0] - 1
    data = data._replace(mask=data.mask.at[last_t].set(False))  # empty
    pad = 7
    padded = SweepData(
        dist=jnp.pad(data.dist, [(0, pad), (0, 0)]),
        mask=jnp.pad(data.mask, [(0, pad), (0, 0)]),
        ang=data.ang, odom=jnp.pad(data.odom, [(0, pad), (0, 0)]),
        u=jnp.pad(data.u, [(0, pad), (0, 0)]))
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    old_map = seed_map(data, x0, cfg)
    x = jnp.pad(jnp.asarray(ds.odom, data.dist.dtype), [(0, pad), (0, 0)])
    _, x_out = refine_sweep_batched(padded, old_map, x, cfg, weights(cfg),
                                    last_t=last_t)
    p = np.asarray(x_out)[last_t, :2]
    assert np.linalg.norm(p - ds.odom[last_t, :2]) < 2.0, p


def test_run_detects_table_overflow():
    # a world with more spawned landmarks than the table holds: the init
    # sweep allocates one label per far-obs frame, far past L=4
    ds = synthetic_world(T=200, n_landmarks=30, world_size=15.0, seed=3)
    cfg = ICMConfig(N=1, L=4, cota=2.0, map_run_cap=0)
    with pytest.raises(RuntimeError, match="overflow"):
        run(ds, cfg)


def test_init_overflow_detected_on_batched_path():
    # the batched init merges its table in-function
    # (nact compacted to <= L), so the overflow witness must come from the
    # RAW allocated-label count — with zero refinement iterations only the
    # init-sweep check can fire, proving the batched path's raw witness
    from icm_slam_tpu.solver.icm import use_batched_init
    ds = synthetic_world(T=200, n_landmarks=30, world_size=15.0, seed=3)
    cfg = ICMConfig(N=0, L=4, cota=2.0, map_run_cap=0)
    assert use_batched_init(cfg)
    with pytest.raises(RuntimeError, match="init sweep"):
        run(ds, cfg, n_iters=0)


def test_assoc_onehot_and_scatter_paths_agree():
    """The one-hot-matmul running-mean build == the scatter segment-sums.

    batched_associate picks between them by assoc_onehot_max_elems (a pure
    latency/bandwidth trade); both must produce the same
    sweep.  Counts are integral sums of 0/1 weights (exact in f32 either
    way); positions may differ by accumulation order only.
    """
    from icm_slam_tpu.solver.icm import _refine_jit, seed_map, weights
    ds = synthetic_world(T=220, n_landmarks=14, seed=5)
    base = dict(N=1, L=256, cota=5.0, map_run_cap=128)
    cfg_oh = ICMConfig(**base)                              # one-hot path
    cfg_sc = ICMConfig(**base, assoc_onehot_max_elems=0)    # scatter path
    data = prepare(ds, cfg_oh)
    cfg_oh = resolve_config(cfg_oh, data)
    cfg_sc = resolve_config(cfg_sc, data)
    assert cfg_oh.map_run_cap == cfg_sc.map_run_cap
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg_oh)
    x = jnp.asarray(ds.odom, data.dist.dtype)
    m_oh, x_oh, w_oh = _refine_jit(data, seed, x, cfg_oh)
    m_sc, x_sc, w_sc = _refine_jit(data, seed, x, cfg_sc)
    np.testing.assert_array_equal(np.asarray(w_oh), np.asarray(w_sc))
    assert int(m_oh.nact) == int(m_sc.nact)
    np.testing.assert_array_equal(np.asarray(m_oh.counts),
                                  np.asarray(m_sc.counts))
    np.testing.assert_allclose(np.asarray(m_oh.pos), np.asarray(m_sc.pos),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(x_oh), np.asarray(x_sc),
                               atol=1e-4)


def test_init_merge_cap_exact_and_witnessed():
    """Cap-sliced init merge (init_merge_cap) is bitwise-equal to the
    full-width merge while the raw allocated-label count fits the cap, and
    run() raises when it does not."""
    from icm_slam_tpu.solver.icm import (_init_jit, seed_map,
                                         use_batched_init)
    from icm_slam_tpu.solver.sweeps import resolve_init_merge_cap
    import jax.numpy as jnp

    ds = synthetic_world(T=240, n_landmarks=20, seed=2)
    cfg = ICMConfig(N=0, L=256, cota=5.0, map_run_cap=64,
                    map_run_cap_checked=True, init_merge_cap=-1,
                    dtype="float32")
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    assert use_batched_init(cfg)
    assert resolve_init_merge_cap(cfg) == 64
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    s_cap, x_cap, r_cap = _init_jit(data, seed, x0, cfg)
    cfg_full = dataclasses.replace(cfg, init_merge_cap=0)
    s_full, x_full, r_full = _init_jit(data, seed, x0, cfg_full)
    assert int(r_cap) == int(r_full) <= 64
    n = int(s_cap.nact)
    assert n == int(s_full.nact)
    np.testing.assert_array_equal(np.asarray(x_cap), np.asarray(x_full))
    np.testing.assert_array_equal(np.asarray(s_cap.pos[:n]),
                                  np.asarray(s_full.pos[:n]))
    np.testing.assert_array_equal(np.asarray(s_cap.counts[:n]),
                                  np.asarray(s_full.counts[:n]))

    # violation: an explicit cap below the allocated-label count must be a
    # hard error from run(), not a silent mass drop
    cfg_bad = ICMConfig(N=0, L=256, cota=5.0, map_run_cap=0,
                        init_merge_cap=4, dtype="float32")
    with pytest.raises(RuntimeError, match="init_merge_cap"):
        run(ds, cfg_bad, n_iters=0)


def test_map_change_empty_maps_yield_zeros_not_nan():
    # an empty map (either side) used to NaN-poison the
    # convergence metrics via nanmin over an all-NaN slice
    from icm_slam_tpu.mapping.landmark_map import MapState, empty_map
    from icm_slam_tpu.solver.icm import map_change

    L = 16
    empty = empty_map(L)
    full = MapState(jnp.ones((L, 2), jnp.float32),
                    jnp.ones((L,), jnp.float32),
                    jnp.asarray(3, jnp.int32))
    for a, b in [(empty, empty), (empty, full), (full, empty)]:
        chg = np.asarray(map_change(a, b))
        assert np.all(np.isfinite(chg)) and np.all(chg == 0.0), chg
    # non-degenerate stays exact: identical maps -> all-zero displacement
    chg = np.asarray(map_change(full, full))
    assert np.allclose(chg, 0.0) and np.all(np.isfinite(chg))
    # and a shifted map reports the shift
    shifted = full._replace(pos=full.pos + jnp.asarray([0.5, 0.0]))
    chg = np.asarray(map_change(shifted, full))
    assert np.allclose(chg, 0.5, atol=1e-6), chg


def test_degenerate_world_run_keeps_finite_metrics():
    # a world whose landmarks never reach cota: the filtered map is empty
    # every iteration; the run must complete with finite (zero) map-change
    # rows instead of NaN
    ds = synthetic_world(T=40, n_landmarks=6, seed=3)
    cfg = ICMConfig(N=2, L=64, cota=1e6, dtype="float32")
    res = run(ds, cfg)
    assert res.map_pos.shape[0] == 0
    assert np.all(np.isfinite(np.asarray(res.changes)))


def test_obs_cap_validated_in_every_mode(seeded_reference_world):
    """Beam compaction also runs in the init sweeps, so a too-small user
    obs_cap must raise even when sweep_mode is sequential (round-4 review:
    the guard used to be keyed on the batched sweep modes only)."""
    from icm_slam_tpu.solver.icm import prepare, resolve_config
    ds = seeded_reference_world.slice(50)
    cfg = ICMConfig(N=1, L=64, sweep_mode="sequential", obs_cap=2,
                    dtype="float32")
    data = prepare(ds, cfg)
    with pytest.raises(ValueError, match="obs_cap"):
        resolve_config(cfg, data)


def test_folded_last_frame_solve_matches_separate_chain():
    # The batched sweep folds the last frame's one-sided solve into the
    # vmapped two-sided batch by zeroing the 6 forward residual rows
    # (sweeps._solve_two_at).  Forcing the legacy separate batch-of-1 LM
    # chain via a (numerically inert) custom extra_two_sided must produce
    # the same trajectory: zero rows add exact zeros to J^T J / J^T r, so
    # any difference is f32 reduction-order noise.
    from icm_slam_tpu.core.energy import EnergyModel, weights
    from icm_slam_tpu.solver.icm import seed_map
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    for T in (41, 40):  # odd/even last_t exercise both parities
        ds = synthetic_world(T=T, n_landmarks=10, seed=7)
        cfg = ICMConfig(N=1, L=32, cota=2.0, map_run_cap=0)
        data = prepare(ds, cfg)
        cfg = resolve_config(cfg, data)
        x0 = jnp.asarray(ds.x0, data.dist.dtype)
        old_map = seed_map(data, x0, cfg)
        x = jnp.asarray(ds.odom, data.dist.dtype)
        w = weights(cfg)

        m_fold, x_fold = refine_sweep_batched(data, old_map, x, cfg, w)

        inert = EnergyModel(
            extra_two_sided=lambda xx, p: jnp.zeros((0,), xx.dtype))
        cfg_legacy = dataclasses.replace(cfg, model=inert)
        m_leg, x_leg = refine_sweep_batched(data, old_map, x, cfg_legacy, w)

        np.testing.assert_allclose(np.asarray(x_fold), np.asarray(x_leg),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(m_fold.pos),
                                   np.asarray(m_leg.pos), atol=1e-5)
        assert int(m_fold.nact) == int(m_leg.nact)


def test_chunked_onehot_sums_match_oneshot():
    # Past the one-shot gate (assoc_onehot_max_elems) the capped
    # running-mean path computes its per-frame sums with a CHUNKED one-hot
    # einsum (lax.map over frame chunks).  Every frame lies entirely inside
    # one chunk, so the sweep must reproduce the one-shot einsum path.
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.solver.icm import seed_map
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    ds = synthetic_world(T=90, n_landmarks=12, seed=11)
    base = ICMConfig(N=1, L=256, cota=2.0, map_run_cap=128,
                     map_run_cap_checked=True)
    data = prepare(ds, base)
    base = resolve_config(base, data)
    assert base.map_run_cap == 128  # the capped fast path must be active
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    old_map = seed_map(data, x0, base)
    x = jnp.asarray(ds.odom, data.dist.dtype)
    w = weights(base)

    m1, x1 = refine_sweep_batched(data, old_map, x, base, w)

    B = data.dist.shape[1]
    # budget for ~7 frames per chunk -> 13 chunks, plus a pad remainder
    tiny = dataclasses.replace(
        base, assoc_onehot_max_elems=7 * B * (base.map_run_cap + 1))
    m2, x2 = refine_sweep_batched(data, old_map, x, tiny, w)

    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(m1.pos), np.asarray(m2.pos),
                               atol=1e-5)
    assert int(m1.nact) == int(m2.nact)


def test_hoist_compaction_exact_on_observer_path():
    # run()'s per-iteration observer path (callback/verbose) pre-compacts
    # beams ONCE via solver.icm.hoist_compaction; the in-sweep cap guard
    # must no-op on the pre-compacted data so every sweep is bitwise
    # identical to running on the raw full-width data (where the sweep
    # compacts internally with the same stable argsort).
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit, _refine_jit,
                                         hoist_compaction, seed_map)

    ds = synthetic_world(T=120, n_landmarks=12, seed=9)
    cfg = ICMConfig(N=2, L=128, cota=2.0)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    assert 0 < cfg.obs_cap < data.dist.shape[1], \
        "fixture must engage the hoist (cap below full beam width)"

    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    state, x, _ = _init_jit(data, seed, x0, cfg)
    m0 = _filter_jit(state, cfg)

    hoisted = hoist_compaction(data, cfg)
    assert hoisted.dist.shape[1] == cfg.obs_cap
    # idempotent: the guard sees B == cap and returns the input unchanged
    assert hoist_compaction(hoisted, cfg) is hoisted

    m_raw, x_raw, m_h, x_h = m0, x, m0, x
    for _ in range(2):
        m_raw, x_raw, w_raw = _refine_jit(data, m_raw, x_raw, cfg)
        m_h, x_h, w_h = _refine_jit(hoisted, m_h, x_h, cfg)
        np.testing.assert_array_equal(np.asarray(x_raw), np.asarray(x_h))
        np.testing.assert_array_equal(np.asarray(m_raw.pos),
                                      np.asarray(m_h.pos))
        np.testing.assert_array_equal(np.asarray(w_raw), np.asarray(w_h))
    assert int(m_raw.nact) == int(m_h.nact)

    # sequential mode keeps the shared 1-D beam vector: hoist must no-op
    seq = dataclasses.replace(cfg, sweep_mode="sequential")
    assert hoist_compaction(data, seq) is data
