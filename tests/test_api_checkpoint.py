"""run_offline checkpoint/resume on the segmented FUSED refinement loop.

Attaching a checkpoint observer used to force the unfused
per-iteration dispatch path (one host dispatch per sweep).  Now a
checkpoint-only run executes ceil(N/K) fused device programs and
checkpoints at segment boundaries; these tests pin the contract:

* segmented results are identical to the unobserved single-program run;
* checkpoints land at segment boundaries (K-iteration crash granularity);
* resume from a segment boundary reproduces the uninterrupted trajectory;
* a per-iteration logger still gets every iteration (stride forced to 1).
"""
import json
import os

import numpy as np
import pytest

from icm_slam_tpu.api import run_offline
from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import synthetic_world


@pytest.fixture(scope="module")
def world():
    ds = synthetic_world(T=200, n_landmarks=15, seed=4)
    cfg = ICMConfig(N=6, L=128, cota=5.0, dtype="float32")
    return ds, cfg


def test_checkpointed_run_matches_unobserved(world, tmp_path):
    ds, cfg = world
    base = run_offline(ds, cfg)
    ck = run_offline(ds, cfg, checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every=5)
    # same math, same program per iteration -> identical trajectories
    np.testing.assert_array_equal(base.x, ck.x)
    np.testing.assert_array_equal(base.map_pos, ck.map_pos)
    # per-iteration metrics still collected inside the fused segments
    assert np.asarray(ck.changes).shape == np.asarray(base.changes).shape
    # checkpoints at segment boundaries only: N=6, K=5 -> k=4 and k=5
    names = sorted(f for f in os.listdir(tmp_path / "ck")
                   if f.startswith("icm_ckpt_"))
    assert names == ["icm_ckpt_4.npz", "icm_ckpt_5.npz"], names


def test_resume_from_segment_boundary(world, tmp_path):
    ds, cfg = world
    ckdir = str(tmp_path / "ck")
    full = run_offline(ds, cfg, checkpoint_dir=ckdir, checkpoint_every=3)
    # simulate a crash after the first segment: drop later checkpoints
    for f in os.listdir(ckdir):
        if f.startswith("icm_ckpt_") and f != "icm_ckpt_2.npz":
            os.remove(os.path.join(ckdir, f))
    res = run_offline(ds, cfg, checkpoint_dir=ckdir, resume=True,
                      checkpoint_every=3)
    np.testing.assert_array_equal(res.x, full.x)
    np.testing.assert_array_equal(res.map_pos, full.map_pos)
    # x_init recovered from the pre-refinement snapshot
    np.testing.assert_array_equal(res.x_init, full.x_init)
    # the resume re-wrote the remaining boundary checkpoints
    names = sorted(f for f in os.listdir(ckdir)
                   if f.startswith("icm_ckpt_"))
    assert "icm_ckpt_5.npz" in names


def test_overflow_raises_before_checkpoint_persists(tmp_path):
    """A table-overflow segment must raise BEFORE the observer writes its
    checkpoint — otherwise a resume would silently continue from
    known-wrong state (review finding, round 4)."""
    # this world passes the init witness at L=256 but allocates ~560
    # provisional labels in the first refinement sweep (drifting odometry
    # re-observes landmarks outside dist_thr -> new-label churn)
    ds = synthetic_world(T=600, n_landmarks=28, seed=0, odo_drift=2e-3)
    cfg = ICMConfig(N=2, L=256, dtype="float32")
    ckdir = tmp_path / "ck"
    with pytest.raises(RuntimeError,
                       match="table overflow in refinement sweep"):
        run_offline(ds, cfg, checkpoint_dir=str(ckdir), checkpoint_every=2)
    leaked = [f for f in os.listdir(ckdir) if f.startswith("icm_ckpt_")]
    assert leaked == [], leaked


def test_logger_keeps_per_iteration_rows(world, tmp_path):
    ds, cfg = world
    log = tmp_path / "m.jsonl"
    run_offline(ds, cfg, checkpoint_dir=str(tmp_path / "ck"),
                log_path=str(log), checkpoint_every=5)
    rows = [json.loads(l) for l in open(log)]
    iters = [r["k"] for r in rows if r.get("event") == "iteration"]
    assert iters == list(range(cfg.N)), iters
