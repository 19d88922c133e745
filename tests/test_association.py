"""The batched association (XLA path) against a brute-force NumPy
nearest-landmark search, at the full table width and at a map_run_cap
slice of it."""
import numpy as np
import jax.numpy as jnp
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.core.geometry import beams_to_world
from icm_slam_tpu.mapping.landmark_map import MapState
from icm_slam_tpu.solver.sweeps import SweepData, batched_associate

T, B = 16, 181


def _problem(nact, L):
    rng = np.random.default_rng(0)
    data = SweepData(
        dist=jnp.asarray(rng.uniform(0.5, 9.5, (T, B)), jnp.float32),
        mask=jnp.asarray(rng.uniform(size=(T, B)) < 0.6),
        ang=jnp.asarray(np.deg2rad(np.arange(B)), jnp.float32),
        odom=jnp.zeros((T, 3), jnp.float32),
        u=jnp.zeros((T, 2), jnp.float32))
    x = jnp.asarray(rng.normal(0, 1, (T, 3)), jnp.float32)
    pos = np.zeros((L, 2), np.float32)
    pos[:nact] = rng.uniform(-10, 10, (nact, 2))
    old = MapState(jnp.asarray(pos), jnp.ones((L,), jnp.float32),
                   jnp.asarray(nact, jnp.int32))
    return data, x, old


@pytest.mark.parametrize("cap", [0, 384], ids=["full_width", "capped"])
@pytest.mark.parametrize("nact", [0, 1, 37, 256])
def test_association_matches_brute_force(nact, cap):
    L = 512
    data, x, old = _problem(nact, L)
    cfg = ICMConfig(L=L, map_run_cap=cap, dist_thr=1.0)
    lab, _, _ = batched_associate(data, old, x, cfg)
    lab = np.asarray(lab)
    mask = np.asarray(data.mask)

    pts = np.asarray(beams_to_world(x, data.dist, data.ang), np.float64)
    ref = np.asarray(old.pos, np.float64)[:nact]
    if nact:
        d = np.linalg.norm(pts[:, :, None, :] - ref[None, None], axis=-1)
        nearest, dmin = d.argmin(-1), d.min(-1)
    else:
        nearest, dmin = np.zeros((T, B), int), np.full((T, B), np.inf)
    far = mask & (dmin > cfg.dist_thr)
    near = mask & ~far

    np.testing.assert_array_equal(lab[~mask], L)
    np.testing.assert_array_equal(lab[near], nearest[near])
    # far beams take their frame's new label (one per frame, in order)
    has_far = far.any(axis=1)
    new_id = nact + np.cumsum(has_far) - 1
    np.testing.assert_array_equal(lab[far],
                                  np.broadcast_to(new_id[:, None],
                                                  (T, B))[far])
    if 0 < nact < 256:
        assert near.any() and far.any()
