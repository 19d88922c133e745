"""Online streaming engine: chunked causal results == batch init sweep."""
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.runtime.online import OnlineSLAM
from icm_slam_tpu.runtime.replay import stream_dataset
from icm_slam_tpu.solver.icm import run


@pytest.mark.parametrize("chunk", [7, 64])
def test_online_matches_offline_init(seeded_reference_world, chunk):
    ds = seeded_reference_world.slice(200)
    # the streaming engine IS the causal sequential init — compare against
    # that engine, not the offline default (batched Picard init)
    cfg = ICMConfig(N=0, L=256, dtype="float32", init_mode="sequential")
    eng = OnlineSLAM(cfg, chunk_size=chunk)
    for frame in stream_dataset(ds):
        eng.push(*frame)
    r_on = eng.finish(refine=False)
    r_off = run(ds, cfg, n_iters=0)
    # run() compacts the LM observation set (obs_cap); the streaming engine
    # cannot (future frames unknown) -> identical math, different f32 op
    # order, so agreement is to float noise rather than bitwise
    np.testing.assert_allclose(r_on.x_init, r_off.x_init, atol=1e-3)
    assert r_on.map_pos.shape == r_off.map_pos.shape
    np.testing.assert_allclose(r_on.map_pos, r_off.map_pos, atol=1e-3)


def test_online_with_refinement(seeded_reference_world):
    """finish(refine=True) CARRIES the streamed state into refinement (no
    init recompute); must land at the offline fixed point (the streamed
    init differs from run()'s only by obs-cap compaction f32 noise)."""
    ds = seeded_reference_world.slice(150)
    cfg = ICMConfig(N=1, L=256, dtype="float32", init_mode="sequential")
    eng = OnlineSLAM(cfg, chunk_size=32)
    for frame in stream_dataset(ds):
        eng.push(*frame)
    res = eng.finish(refine=True)
    ref = run(ds, cfg)
    ate = np.sqrt(((res.x[:, :2] - ref.x[:, :2]) ** 2).sum(1)).mean()
    assert ate < 5e-3, ate
    assert res.map_pos.shape == ref.map_pos.shape
    # the streamed trajectory is reported as x_init verbatim
    assert res.x_init.shape == ref.x_init.shape


def test_synchronizer_bounded_memory_and_counters():
    """Long session: consumed messages are pruned; desync drops counted."""
    from icm_slam_tpu.runtime.ingest import FrameSynchronizer
    sync = FrameSynchronizer(deltat=0.1)
    rng = np.random.default_rng(0)
    n_frames = 0
    for k in range(5000):
        t = k * 0.1
        # drop the odometry for a stretch -> desynchronized grid points
        sync.feed_laser(t + 1e-3, np.full(8, 5.0))
        if not (1000 <= k < 1050):
            sync.feed_odometry(t - 1e-3, np.zeros(3), np.zeros(2))
        if k % 97 == 0:
            n_frames += len(list(sync.drain()))
    n_frames += len(list(sync.drain()))
    st = sync.stats
    assert st["laser_buffered"] < 200, st    # bounded, not 5000
    assert st["odo_buffered"] < 200, st
    assert st["pruned"] > 9000, st
    assert 0 < st["dropped"] <= 51, st       # the odometry gap, counted
    assert st["paired"] == n_frames
    assert n_frames >= 5000 - 52 - 2


def test_online_empty_first_frame():
    """Bootstrap with an all-max-range first frame must not crash."""
    from icm_slam_tpu.data.datasets import synthetic_world
    ds = synthetic_world(T=40, n_landmarks=6, seed=5)
    ds.scans[0] = 10.0
    cfg = ICMConfig(N=0, L=64, cota=2.0, dtype="float32")
    eng = OnlineSLAM(cfg, chunk_size=8)
    for frame in stream_dataset(ds):
        eng.push(*frame)
    res = eng.finish(refine=False)
    assert np.isfinite(res.x_init).all()


def test_finish_without_frames_raises_clearly():
    """An empty capture session must fail loudly, not with an obscure
    np.concatenate traceback (round-4 review)."""
    eng = OnlineSLAM(ICMConfig(N=1, L=64, dtype="float32"))
    with pytest.raises(RuntimeError, match="captured no frames"):
        eng.finish()
