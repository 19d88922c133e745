"""Bounded landmark table: association, incremental updates, prune/merge.

Fixed-shape redesign of the reference's Mapa class (ICM_SLAM.py:104-265):

* the table is a fixed (L, 2) array + (L,) observation counts + a live-count
  scalar — no dynamic growth; dead slots are masked.
* data association is a masked nearest-landmark search (batched distance
  matrix + argmin) instead of scipy cdist loops.
* the per-landmark Python update loop (ICM_SLAM.py:184-194) becomes one
  segment-sum scatter.
* prune + merge (ICM_SLAM.py:204-265) is reproduced in fixed shape, including
  the reference's sequential relabel loop semantics (iteration order matters)
  and its d==0 -> max sentinel quirk.

New-landmark allocation replicates the reference quirk at ICM_SLAM.py:176:
far observations of a frame collapse into ONE new landmark (the reference
clusters an empty column slice, so all pairwise distances are zero).  Set
``replicate_new_obs_quirk=False`` in the config for spatial clustering of new
observations per frame (connected components at dist_thr) instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class MapState(NamedTuple):
    pos: jnp.ndarray     # (L, 2) landmark positions (dead slots: zeros)
    counts: jnp.ndarray  # (L,) observation counts
    nact: jnp.ndarray    # () int32 live-landmark count


def empty_map(L, dtype=jnp.float32) -> MapState:
    return MapState(jnp.zeros((L, 2), dtype), jnp.zeros((L,), dtype),
                    jnp.zeros((), jnp.int32))


def connected_component_labels(pts, mask, dist_thr):
    """Deterministic threshold-graph connected components over masked points.

    pts: (B, 2), mask: (B,). Returns (B,) labels: each component labelled by
    its minimum member index (masked-out points get B).  Equals single-linkage
    clustering cut at dist_thr.  Fixed iteration count (log2 B rounds of
    min-label propagation, unrolled as a lax loop).
    """
    B = pts.shape[0]
    diff = pts[:, None, :] - pts[None, :, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    adj = (d <= dist_thr) & mask[:, None] & mask[None, :]
    adj = adj | (jnp.eye(B, dtype=bool) & mask[:, None])
    init = jnp.where(mask, jnp.arange(B, dtype=jnp.int32), B)

    def body(_, lab):
        # propagate the minimum label across edges
        neigh = jnp.where(adj, lab[None, :], B)
        return jnp.minimum(lab, jnp.min(neigh, axis=1))

    n_rounds = max(1, math.ceil(math.log2(B)) + 1) if B > 1 else 1
    lab = jax.lax.fori_loop(0, n_rounds, body, init)
    return lab


def compact_labels(lab, valid, B):
    """Renumber labels to 0..k-1 preserving order of first appearance by value.

    lab: (B,) int labels in [0, B]; valid: (B,). Invalid entries -> B.
    """
    used = jnp.zeros((B + 1,), jnp.int32).at[jnp.where(valid, lab, B)].set(1)
    used = used.at[B].set(0)
    newidx = jnp.cumsum(used) - 1
    return jnp.where(valid, newidx[lab], B)


def associate(ref_pos, ref_live, pts, mask, dist_thr):
    """Nearest-landmark association. (ICM_SLAM.py:168-172)

    ref_pos: (L, 2); ref_live: (L,) bool; pts: (B, 2); mask: (B,).
    Returns (labels (B,) in [0, L) or -1 for far, or L for masked-out;
             min_dist (B,)).
    """
    diff = pts[:, None, :] - ref_pos[None, :, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))        # (B, L)
    d = jnp.where(ref_live[None, :], d, jnp.inf)
    min_dist = jnp.min(d, axis=1)
    labels = jnp.argmin(d, axis=1).astype(jnp.int32)
    L = ref_pos.shape[0]
    labels = jnp.where(min_dist > dist_thr, -1, labels)
    labels = jnp.where(mask, labels, L)
    return labels, min_dist


def allocate_new_labels(labels, pts, mask, nact, dist_thr, quirk=True):
    """Assign labels >= nact to far observations (labels == -1).

    quirk=True: reference behavior — all far obs in the frame share ONE new
    label (ICM_SLAM.py:176 empty-slice bug). quirk=False: spatial connected
    components at dist_thr, labelled nact, nact+1, ... deterministically.
    Returns (labels, n_new).
    """
    far = labels == -1
    if quirk:
        labels = jnp.where(far, nact, labels)
        n_new = jnp.any(far).astype(jnp.int32)
        return labels, n_new
    B = pts.shape[0]
    comp = connected_component_labels(pts, far & mask, dist_thr)
    comp = compact_labels(comp, far & mask, B)
    labels = jnp.where(far, nact + comp, labels)
    n_new = jnp.where(jnp.any(far), jnp.max(jnp.where(far, comp, -1)) + 1, 0)
    return labels, n_new.astype(jnp.int32)


def scatter_update(state: MapState, pts, labels, n_new) -> MapState:
    """Fold observations into the table by incremental weighted mean.

    Replaces the per-landmark loop at ICM_SLAM.py:184-194 with one
    segment-sum.  labels == L acts as the discard slot.
    """
    L = state.pos.shape[0]
    w = (labels < L).astype(state.pos.dtype)
    sums = jax.ops.segment_sum(pts * w[:, None], labels, num_segments=L + 1)[:L]
    cnt = jax.ops.segment_sum(w, labels, num_segments=L + 1)[:L]
    tot = state.counts + cnt
    new_pos = jnp.where((cnt > 0)[:, None],
                        (sums + state.pos * state.counts[:, None])
                        / jnp.maximum(tot, 1.0)[:, None],
                        state.pos)
    return MapState(new_pos, tot, state.nact + n_new)


def update(state: MapState, ref_pos, ref_nact, pts, mask, dist_thr,
           quirk=True) -> Tuple[MapState, jnp.ndarray]:
    """Full association + update step (Mapa.actualizar, ICM_SLAM.py:128-201).

    Association runs against the frozen (ref_pos, ref_nact); accumulation goes
    into ``state``. Returns (new_state, labels).
    """
    L = state.pos.shape[0]
    ref_live = jnp.arange(L) < ref_nact
    labels, _ = associate(ref_pos, ref_live, pts, mask, dist_thr)
    labels, n_new = allocate_new_labels(labels, pts, mask, state.nact,
                                        dist_thr, quirk)
    new_state = scatter_update(state, pts, labels, n_new)
    return new_state, labels


def filter_map(state: MapState, cota, dist_thr, live_cap: int = 0
               ) -> MapState:
    """Prune landmarks seen < cota times, merge near-duplicates.

    Fixed-shape reproduction of Mapa.filtrar (ICM_SLAM.py:204-265):
      1. drop counts < cota (stable compaction)
      2. nearest-neighbour distances with the d==0 -> max sentinel
      3. the reference's *sequential* relabel loop (ascending over close
         pairs; order-dependent) via fori_loop
      4. label compaction identical to the reference's descending re-index
      5. count-weighted merge means via segment-sum

    ``live_cap`` (static): when > 0, the merge machinery — the K×K
    distance matrix, the K-step sequential relabel loop, the segment
    sums — runs on the first K = live_cap compacted rows instead of all
    L.  EXACT when the kept-landmark count <= live_cap; the kept count
    is bounded by total_obs / cota, the same provable bound run() uses
    to enable map_run_cap (solver.icm.resolve_config), so callers pass
    config.map_run_cap (0 when disabled).  The L-step relabel scan
    is latency-bound, so the cap-sized slice shortens it L/cap-fold.
    """
    L = state.pos.shape[0]
    K = live_cap if 0 < live_cap < L else L
    idx = jnp.arange(L)
    live = idx < state.nact
    keep = live & (state.counts >= cota)
    # stable compaction: kept landmarks first, original order preserved.
    # cumsum target + drop-mode scatter, not an L-element argsort (a
    # sort takes ~log^2 L sequential rounds for the same result)
    tgt = jnp.where(keep, jnp.cumsum(keep) - 1, K)
    pos = jnp.zeros((K, 2), state.pos.dtype).at[tgt].set(
        state.pos, mode="drop")
    counts = jnp.zeros((K,), state.counts.dtype).at[tgt].set(
        state.counts, mode="drop")
    n = jnp.sum(keep).astype(jnp.int32)
    idx_k = jnp.arange(K)
    live_k = idx_k < n

    diff = pos[:, None, :] - pos[None, :, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    pair = live_k[:, None] & live_k[None, :]
    d_live = jnp.where(pair, d, -jnp.inf)
    dmax = jnp.max(d_live)
    # diagonal masked explicitly (XLA norm reassociation leaves nonzero
    # garbage there); near-zero off-diagonals keep the reference's
    # duplicate-landmark sentinel
    d = jnp.where(d < 1e-9, dmax, d)
    d = jnp.where(jnp.eye(K, dtype=bool), dmax, d)
    d = jnp.where(pair, d, jnp.inf)
    nn = jnp.argmin(d, axis=1).astype(jnp.int32)
    nnd = jnp.min(d, axis=1)
    close = live_k & (nnd < dist_thr)

    def relabel_body(i, lab):
        tgt = lab[nn[i]]
        new = jnp.where(close[i] & (lab == tgt), lab[i], lab)
        return jnp.where(close[i], new, lab)

    # the sequential loop is identity when nothing is close (every body
    # iteration no-ops) — the common steady-state case once duplicates
    # are merged away; skip its K latency-bound steps then.  When it does
    # run, walk only the live rows: close[i] is False for every i >= n
    # (live_k masks it), so the remaining K - n iterations are provably
    # identity and the latency-bound walk stops at the dynamic live count
    def relabel_walk(c):
        i, lab = c
        return i + 1, relabel_body(i, lab)

    lab = jax.lax.cond(
        jnp.any(close),
        lambda: jax.lax.while_loop(
            lambda c: c[0] < n, relabel_walk,
            (jnp.int32(0), idx_k.astype(jnp.int32)))[1],
        lambda: idx_k.astype(jnp.int32))
    lab = compact_labels(lab, live_k, K)
    n_final = jnp.where(n > 0, jnp.max(jnp.where(live_k, lab, -1)) + 1, 0)

    w = jnp.where(live_k, counts, 0.0)
    sums = jax.ops.segment_sum(pos * w[:, None], lab, num_segments=K + 1)[:K]
    cnts = jax.ops.segment_sum(w, lab, num_segments=K + 1)[:K]
    merged = jnp.where((cnts > 0)[:, None],
                       sums / jnp.maximum(cnts, 1.0)[:, None], 0.0)
    if K < L:
        merged = jnp.zeros((L, 2), merged.dtype).at[:K].set(merged)
        cnts = jnp.zeros((L,), cnts.dtype).at[:K].set(cnts)
    return MapState(merged, cnts, n_final.astype(jnp.int32))


def seed_from_clusters(L, pts, labels, dtype=jnp.float32) -> MapState:
    """Build the initial map from first-frame cluster labels.

    (first branch of Mapa.actualizar, ICM_SLAM.py:160-165; labels come from
    the host-side hierarchical clustering — run exactly once per dataset.)
    """
    labels = jnp.asarray(labels, jnp.int32)
    k = jnp.max(labels) + 1
    sums = jax.ops.segment_sum(jnp.asarray(pts, dtype), labels,
                               num_segments=L)
    cnt = jax.ops.segment_sum(jnp.ones((pts.shape[0],), dtype), labels,
                              num_segments=L)
    pos = jnp.where((cnt > 0)[:, None], sums / jnp.maximum(cnt, 1.0)[:, None],
                    0.0)
    return MapState(pos, cnt, k.astype(jnp.int32))
