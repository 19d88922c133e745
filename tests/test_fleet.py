"""Fleet mode: run_batched == per-world run(), as one device program.

A single run is latency-bound and leaves the device idle much of the
time; run_batched fills it with W independent worlds.
Correctness contract: per-world results are bitwise-equal to run() on CPU
(the vmapped program executes the same ops per lane).
"""
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver.icm import (prepare, resolve_fleet_config, run,
                                     run_batched)


def test_batched_matches_per_world():
    worlds = [synthetic_world(T=300, n_landmarks=25, seed=s)
              for s in (0, 1, 2)]
    cfg = ICMConfig(N=4, L=256, cota=10.0, dtype="float32")
    batched = run_batched(worlds, cfg)
    assert len(batched) == 3
    # solo runs must use the SAME merged caps the batch resolved (solo
    # resolution picks per-world caps; different f32 reduction widths
    # deviate at borderline associations — see resolve_fleet_config)
    merged = resolve_fleet_config(cfg, [prepare(w, cfg) for w in worlds])
    for ds, rb in zip(worlds, batched):
        r1 = run(ds, merged)
        assert r1.map_pos.shape == rb.map_pos.shape
        np.testing.assert_allclose(rb.x, r1.x, atol=1e-5)
        np.testing.assert_allclose(rb.x_init, r1.x_init, atol=1e-5)
        np.testing.assert_allclose(rb.map_pos, r1.map_pos, atol=1e-5)


def test_batched_rejects_mixed_shapes():
    worlds = [synthetic_world(T=300, seed=0), synthetic_world(T=301, seed=1)]
    with pytest.raises(ValueError, match="identical dataset shapes"):
        run_batched(worlds, ICMConfig(N=1, L=128, cota=10.0))


def test_batched_empty():
    assert run_batched([], ICMConfig(N=1)) == []


def test_batched_matches_per_world_heterogeneous_caps():
    """Worlds whose solo resolutions prove DIFFERENT map_run_caps (128 vs
    256): the merged config must carry the widest cap marked checked, so a
    solo run() given it reproduces the fleet result bitwise instead of
    re-shrinking to its own tighter bound."""
    worlds = [synthetic_world(T=256, n_landmarks=10, world_size=25.0,
                              seed=0),
              synthetic_world(T=256, n_landmarks=30, world_size=22.0,
                              seed=2)]
    cfg = ICMConfig(N=2, L=1024, cota=40.0, dtype="float32")
    from icm_slam_tpu.solver.icm import resolve_config
    solo_caps = [resolve_config(cfg, prepare(w, cfg)).map_run_cap
                 for w in worlds]
    assert sorted(solo_caps) == [128, 256], solo_caps
    merged = resolve_fleet_config(cfg, [prepare(w, cfg) for w in worlds])
    assert merged.map_run_cap == 256 and merged.map_run_cap_checked
    # run() must NOT re-shrink the checked merged cap
    assert resolve_config(merged, prepare(worlds[0], cfg)).map_run_cap == 256
    batched = run_batched(worlds, cfg)
    for ds, rb in zip(worlds, batched):
        r1 = run(ds, merged)
        assert r1.map_pos.shape == rb.map_pos.shape
        # not bitwise here: with capped association paths the vmapped
        # program packs lanes differently and reorders f32 reductions
        # (measured: ~2% of elements at <= 1e-5) — the contract is
        # same-census + f32-noise-level poses
        np.testing.assert_allclose(rb.x, r1.x, atol=1e-4)
        np.testing.assert_allclose(rb.map_pos, r1.map_pos, atol=1e-4)
