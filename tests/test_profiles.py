"""Full-depth profile matrix on the seeded reference-shape world.

Every performance profile the benchmarks quote must hold full-run quality
(ATE < 0.1 m vs the oracle golden, exact landmark census).  This matrix
is the regression gate that catches profile-dependent init/sweep
interactions — e.g. init_chunk_len=48 passed the 2-pass default but lost
a landmark at the 1-pass fast profile on the reference's dataset.
"""
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.solver.icm import run

PROFILES = {"fast": dict(pose_passes=1, pose_gn_iters=6),
            "default": dict(pose_passes=2, pose_gn_iters=8),
            "turbo": dict(pose_passes=1, pose_gn_iters=3),
            "ultra": dict(pose_passes=1, pose_gn_iters=2),
            "max": dict(pose_passes=1, pose_gn_iters=1)}


def _check(res, golden):
    gx = golden["x"].T
    ate = float(np.mean(np.linalg.norm(res.x[:, :2] - gx[:, :2], axis=1)))
    assert ate < 0.10, f"ATE {ate:.4f}"
    assert res.map_pos.shape[0] == golden["map"].shape[1], \
        (res.map_pos.shape[0], golden["map"].shape[1])


@pytest.mark.slow
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_reference_world_full_depth(seeded_reference_world, golden_full,
                                    profile):
    res = run(seeded_reference_world,
              ICMConfig(N=30, L=1024, **PROFILES[profile]))
    _check(res, golden_full)


@pytest.mark.slow
def test_jacobi_full_depth(seeded_reference_world, golden_full):
    """pose_update="jacobi" (one full pass per pose_pass, half the
    sequential LM depth) must hold full-run quality like every published
    profile."""
    res = run(seeded_reference_world,
              ICMConfig(N=30, L=1024, pose_update="jacobi",
                        **PROFILES["default"]))
    _check(res, golden_full)


@pytest.mark.slow
def test_init_c64_candidate_full_depth(seeded_reference_world, golden_full):
    """The C=64 init recipe (C=64 chunks + no-final-assoc + init_gn=4, ~67%
    fewer sequential init steps) must hold full-run quality at the FAST
    profile — the historical landmark-loss mode for big init chunks."""
    kw = dict(init_chunk_len=64, init_final_assoc=False, init_gn_iters=4,
              **PROFILES["fast"])
    res = run(seeded_reference_world, ICMConfig(N=30, L=1024, **kw))
    _check(res, golden_full)
