"""End-to-end golden-trace validation on the seeded reference-shape world.

The target is ATE-level agreement with the reference trajectory (the golden
traces are generated by the NumPy oracle in tests/oracle/), not
pose-bitwise equality: the engine replaces Nelder-Mead (xtol=1e-3) with
Gauss-Newton, so individual minimizers differ at the millimeter level.

Scale for tolerances: on the reference's own dataset its trajectory
deviates from the simulator ground-truth odometry by 1.41 m RMSE
(BASELINE.md); we require the engine to stay within a few cm of the
reference trajectory.
"""
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.solver.icm import run

ATE_TOL = 0.10  # meters, mean absolute trajectory error vs reference


def _ate(a, b):
    return float(np.sqrt(((a[:, :2] - b[:, :2]) ** 2).sum(1)).mean())


@pytest.fixture(scope="module")
def ds400(seeded_reference_world):
    return seeded_reference_world.slice(400)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_golden_trace_T400(ds400, golden_small, mode):
    # L = the reference's table (a 400-frame slice of the seeded world
    # allocates more than 256 labels).  Each mode runs its default init:
    # the batched sweep's is the batched Picard init.
    cfg = ICMConfig(N=3, L=1024, sweep_mode=mode, dtype="float32")
    res = run(ds400, cfg)
    gx_init = golden_small["x_init"].T
    gx = golden_small["x"].T
    assert _ate(res.x_init, gx_init) < ATE_TOL
    assert _ate(res.x, gx) < ATE_TOL
    # same landmark census as the reference
    assert res.map_pos.shape[0] == golden_small["map"].shape[1]
    from scipy.spatial.distance import cdist
    dev = cdist(res.map_pos, golden_small["map"].T).min(axis=0).max()
    assert dev < 0.15


def test_batched_matches_sequential(ds400):
    # pin the init engine so this compares the REFINE sweeps in isolation
    # (batched-init-vs-sequential-init parity is tested in
    # tests/test_init_batched.py at its own tolerance)
    cfg_s = ICMConfig(N=2, L=1024, sweep_mode="sequential", dtype="float32")
    cfg_b = ICMConfig(N=2, L=1024, sweep_mode="batched", dtype="float32",
                      init_mode="sequential")
    rs = run(ds400, cfg_s)
    rb = run(ds400, cfg_b)
    assert _ate(rs.x, rb.x) < 0.02
    assert rs.map_pos.shape == rb.map_pos.shape


def test_determinism(ds400):
    cfg = ICMConfig(N=1, L=1024, sweep_mode="batched", dtype="float32")
    r1 = run(ds400, cfg)
    r2 = run(ds400, cfg)
    np.testing.assert_array_equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.map_pos, r2.map_pos)


def test_synthetic_world_convergence():
    """On a clean synthetic world the engine must recover the landmarks."""
    from icm_slam_tpu.data.datasets import synthetic_world
    ds = synthetic_world(T=300, n_landmarks=12, seed=1)
    cfg = ICMConfig(N=2, L=128, cota=30.0, dtype="float32")
    res = run(ds, cfg)
    assert res.map_pos.shape[0] >= 6  # recovered a good fraction
    # trajectory should stay near the (nearly noise-free) odometry
    assert _ate(res.x, ds.odom) < 0.5
