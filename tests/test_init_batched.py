"""Batched (chunked-Picard) init sweep vs the faithful sequential scan.

The batched init (solver.sweeps.init_sweep_batched) replaces the T-step
causal scan with ~T/C chunk steps of fully-batched Picard rounds.  Its
correctness story:

* with tiny chunks (C=2) it reproduces the sequential init EXACTLY (same
  labels, same running means, same poses) — the machinery test;
* at production settings (C=32, rounds until the chunk settles, at most
  C) it reaches the same fixed point up to the LM solvers' f32 rounding,
  gated end-to-end by the golden-trace tests (test_e2e) and the
  full-depth profile matrix (test_profiles).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver.icm import (_init_jit, prepare, resolve_config,
                                     seed_map, use_batched_init)


def _init(ds, cfg):
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    return _init_jit(data, seed, x0, cfg)


@pytest.mark.parametrize("dataset", ["reference", "synthetic"])
def test_tiny_chunks_match_sequential_exactly(dataset, seeded_reference_world):
    ds = seeded_reference_world.slice(200) if dataset == "reference" else \
        synthetic_world(T=150, n_landmarks=12, seed=3)
    base = ICMConfig(N=0, L=256, dtype="float32")
    st_s, x_s, _ = _init(ds, dataclasses.replace(base, init_mode="sequential"))
    st_b, x_b, _ = _init(ds, dataclasses.replace(
        base, init_mode="batched", init_chunk_len=2))
    # atol covers f32 solver-path differences (the vmapped solves use the
    # closed-form 3x3 LM step, the scan uses LU) — same fixed point
    np.testing.assert_allclose(np.asarray(x_b), np.asarray(x_s),
                               atol=2e-3, rtol=0)
    # raw tables differ only by the batched init's duplicate pre-merge;
    # after the normal filter step both maps must coincide
    from icm_slam_tpu.mapping.landmark_map import filter_map
    cfg = dataclasses.replace(base, init_mode="sequential")
    f_s = filter_map(st_s, cfg.cota, cfg.dist_thr)
    f_b = filter_map(st_b, cfg.cota, cfg.dist_thr)
    assert int(f_b.nact) == int(f_s.nact)
    n = int(f_s.nact)
    np.testing.assert_allclose(np.asarray(f_b.pos[:n]),
                               np.asarray(f_s.pos[:n]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(f_b.counts[:n]),
                               np.asarray(f_s.counts[:n]), atol=1.0)


def test_production_settings_ate_parity(seeded_reference_world):
    ds = seeded_reference_world.slice(400)
    base = ICMConfig(N=0, L=1024, dtype="float32")
    _, x_s, _ = _init(ds, dataclasses.replace(base, init_mode="sequential"))
    _, x_b, _ = _init(ds, dataclasses.replace(base, init_mode="batched"))
    ate = float(np.mean(np.linalg.norm(
        np.asarray(x_b)[:, :2] - np.asarray(x_s)[:, :2], axis=1)))
    assert ate < 0.1, ate


def test_blackout_frames_dead_reckon(seeded_reference_world):
    """Empty frames inside a chunk chain exactly (kinematic increments)."""
    import dataclasses as dc
    ds = seeded_reference_world.slice(120)
    ds = dc.replace(ds, scans=ds.scans.copy())  # slice() returns views
    ds.scans[40:70] = 10.0  # blackout: no informative beams
    base = ICMConfig(N=0, L=256, dtype="float32")
    _, x_b, _ = _init(ds, dataclasses.replace(base, init_mode="batched"))
    # inside the blackout every pose must chain EXACTLY on its
    # predecessor via the kinematic model (ICM_ROS.py:104-106)
    from icm_slam_tpu.core.geometry import unicycle_step
    xb = np.asarray(x_b)
    pred = np.asarray(unicycle_step(jnp.asarray(xb[44:69]),
                                    jnp.asarray(ds.u[44:69], xb.dtype),
                                    base.deltat))
    np.testing.assert_allclose(xb[45:70], pred, atol=1e-4)


def test_dispatch_rules():
    assert use_batched_init(ICMConfig())
    assert not use_batched_init(ICMConfig(sweep_mode="sequential"))
    assert not use_batched_init(ICMConfig(replicate_new_obs_quirk=False))
    assert use_batched_init(ICMConfig(sweep_mode="sequential",
                                      init_mode="batched"))
    from icm_slam_tpu.core.energy import EnergyModel
    assert not use_batched_init(ICMConfig(model=EnergyModel()))
