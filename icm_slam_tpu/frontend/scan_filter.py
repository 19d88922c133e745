"""Lidar scan filtering — masked, fixed-shape, fully batched.

Reimplements the reference's filtrar_z (ICM_SLAM.py:22-58) as a fixed-shape
masked pipeline so the whole dataset filters in ONE fused XLA computation:

  1. median filter, window 3, zero-padded edges (scipy.signal.medfilt semantics)
  2. range gate: keep beams with r < rango_laser_max
  3. isolation prune: keep beams whose nearest *valid* neighbour point lies
     within dist_thr (pairwise distances; exact-zero distances get the
     reference's 100.0 sentinel, ICM_SLAM.py:48)
  4. frames with <= 1 valid beam produce an all-false mask (empty frame)

Output is (dist, mask) of static shape — the variable-length ``zz`` array of
the reference becomes a boolean mask, which is what lets every later stage
(association, potentials) batch over frames on the device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from icm_slam_tpu.core.geometry import beam_angles


def median3(r):
    """Window-3 median with zero-padded edges (scipy.signal.medfilt)."""
    prev = jnp.concatenate([jnp.zeros_like(r[..., :1]), r[..., :-1]], axis=-1)
    nxt = jnp.concatenate([r[..., 1:], jnp.zeros_like(r[..., :1])], axis=-1)
    lo = jnp.minimum(prev, nxt)
    hi = jnp.maximum(prev, nxt)
    return jnp.minimum(jnp.maximum(r, lo), hi)


def filter_scan(r, ang, max_range, dist_thr):
    """Filter one scan. r: (B,) ranges, ang: (B,) beam angles.

    Returns (dist (B,), mask (B,)): mask=True for informative beams; dist is
    the median-filtered range (valid everywhere, gated by mask downstream).
    """
    rm = median3(r)
    valid = rm < max_range
    n_valid = jnp.sum(valid)
    pts = rm[:, None] * jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
    diff = pts[:, None, :] - pts[None, :, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    pair_ok = valid[:, None] & valid[None, :]
    # reference quirk: any zero distance (incl. the diagonal) -> 100.0.
    # The diagonal is masked EXPLICITLY: XLA may reassociate the norm so
    # self-distances come out as ~eps*|p|^2 garbage instead of exact zeros
    # (~1e-3 in float32).  Near-zero off-diagonal entries (duplicate points)
    # keep the sentinel via a small threshold.
    d = jnp.where(d < 1e-9, 100.0, d)
    d = jnp.where(jnp.eye(d.shape[0], dtype=bool), 100.0, d)
    d = jnp.where(pair_ok, d, jnp.inf)
    nearest = jnp.min(d, axis=1)
    mask = valid & (nearest <= dist_thr) & (n_valid > 1)
    return rm, mask


@functools.partial(jax.jit, static_argnames=("n_beams", "step_deg", "start_deg"))
def filter_scans(scans, max_range, dist_thr, n_beams, step_deg=1.0,
                 start_deg=0.0):
    """Batched scan filter over a whole dataset.

    scans: (T, B) preprocessed ranges. Returns (dist (T,B), mask (T,B)).
    """
    ang = beam_angles(n_beams, step_deg, start_deg, dtype=scans.dtype)
    return jax.vmap(lambda r: filter_scan(r, ang, max_range, dist_thr))(scans)


def preprocess_ranges(raw, max_range, radio):
    """Ingest preprocessing: NaN -> max range, add tree radius, clip.

    (sensors_definitions.py:21-22 / external_options.py:56)
    """
    z = jnp.nan_to_num(raw, nan=max_range)
    return jnp.minimum(z + radio, max_range)
