"""Full-chain Gauss-Newton BA backend (Schur over landmarks)."""
import numpy as np
import jax.numpy as jnp

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.core.energy import weights
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver.icm import prepare, run, seed_map
from icm_slam_tpu.solver.sweeps import batched_associate


def test_ba_energy_decreases():
    from icm_slam_tpu.models.bundle_adjustment import (BAProblem, ba_refine,
                                                       energy)
    ds = synthetic_world(T=120, n_landmarks=10, seed=2)
    cfg = ICMConfig(N=1, L=256, cota=5.0, dtype="float32")
    data = prepare(ds, cfg)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    # perturb the odometry trajectory so BA has real work to do
    rng = np.random.default_rng(0)
    x = jnp.asarray(ds.odom + rng.normal(0, 0.05, ds.odom.shape),
                    data.dist.dtype)
    w = weights(cfg)

    labels, amap, _ = batched_associate(data, seed, x, cfg)
    L = seed.pos.shape[0]
    prob = BAProblem(data, data.dist, jnp.broadcast_to(data.ang, data.dist.shape),
                     labels, ((labels < L) & data.mask).astype(x.dtype),
                     amap.counts, amap.counts > 0)
    e0 = float(energy(x, amap.pos, prob, w))

    final, x_opt = ba_refine(data, seed, x, cfg, w, gn_iters=5, cg_iters=40)
    e1 = float(energy(x_opt, final.pos, prob, w))
    # solver criteria (the energy has a large irreducible sensor-noise
    # floor, so absolute decrease is small): never increase, and reach at
    # least the quality of the obvious candidate — the noise-free odometry
    # trajectory with its optimal (segment-mean) map
    assert e1 <= e0
    xg = jnp.asarray(ds.odom, data.dist.dtype)
    e_odom = float(energy(xg.at[0].set(x[0]), amap.pos, prob, w))
    assert e1 <= e_odom + 1e-3, (e1, e_odom)
    # pose 0 is gauge-anchored
    np.testing.assert_allclose(np.asarray(x_opt[0]), np.asarray(x[0]),
                               atol=1e-7)


def test_ba_ground_truth_parity():
    """Against KNOWN truth (synthetic world), joint BA matches batched ICM
    quality — the round-1 'BA value unproven' experiment, kept as a
    regression gate.  Full sweep: benchmarks/ba_eval.py."""
    ds, xt, _ = synthetic_world(T=300, n_landmarks=20, seed=3,
                                odo_drift=1e-3, return_truth=True)

    def ate(x):
        return float(np.sqrt(((x[:, :2] - xt[:, :2]) ** 2).sum(1)).mean())

    r_icm = run(ds, ICMConfig(N=4, L=256, cota=5.0, dtype="float32",
                              sweep_mode="batched"))
    r_ba = run(ds, ICMConfig(N=4, L=256, cota=5.0, dtype="float32",
                             sweep_mode="ba"))
    assert ate(r_ba.x) < max(1.25 * ate(r_icm.x), ate(r_icm.x) + 0.02), \
        (ate(r_ba.x), ate(r_icm.x))


def test_ba_mode_matches_icm_fixed_point(seeded_reference_world):
    """BA and ICM modes should land near the same solution on the
    reference-shape world."""
    ds = seeded_reference_world.slice(300)
    r_icm = run(ds, ICMConfig(N=2, L=1024, sweep_mode="batched",
                              dtype="float32"))
    r_ba = run(ds, ICMConfig(N=2, L=1024, sweep_mode="ba", dtype="float32"))
    d = np.sqrt(((r_icm.x[:, :2] - r_ba.x[:, :2]) ** 2).sum(1)).mean()
    assert d < 0.1, d
    assert r_icm.map_pos.shape == r_ba.map_pos.shape


def test_windowed_ba_mode(seeded_reference_world):
    """Windowed BA (64-keyframe blocks) matches the ICM fixed point."""
    ds = seeded_reference_world.slice(300)
    r_icm = run(ds, ICMConfig(N=2, L=1024, sweep_mode="batched",
                              dtype="float32"))
    r_win = run(ds, ICMConfig(N=2, L=1024, sweep_mode="windowed_ba",
                              dtype="float32", ba_gn_iters=4))
    d = np.sqrt(((r_icm.x[:, :2] - r_win.x[:, :2]) ** 2).sum(1)).mean()
    assert d < 0.05, d
    assert r_icm.map_pos.shape == r_win.map_pos.shape


def test_windowed_forward_edge_masked_at_trajectory_end():
    """A window ending exactly at the last real frame must give that pose
    the one-sided treatment: with no real frame after the window, the
    forward chain edge (whose frozen 'next' pose clamps to the window's
    OWN stale last pose — a self-edge) must contribute zero residuals
    (review finding, round 4)."""
    from icm_slam_tpu.models.windowed_ba import _window_residuals

    rng = np.random.default_rng(0)
    W, K = 4, 3
    f32 = jnp.float32
    p = jnp.asarray(rng.normal(size=(W, 3)), f32)
    x_prev = jnp.asarray(rng.normal(size=3), f32)
    x_next = p[-1] + f32(0.5)     # the stale-clamp case
    zeros = jnp.zeros((W, K), f32)
    args = (zeros, zeros, jnp.zeros((W, K), bool),
            jnp.zeros((W, K, 2), f32),
            jnp.asarray(rng.normal(size=(W, 2)), f32),
            jnp.asarray(rng.normal(size=(W, 3)), f32),
            jnp.asarray(rng.normal(size=3), f32),
            jnp.asarray(rng.normal(size=2), f32),
            jnp.asarray(rng.normal(size=3), f32),
            jnp.ones((W,), bool))
    w = weights(ICMConfig(dtype="float32"))
    r_on = _window_residuals(p, x_prev, x_next, *args,
                             jnp.asarray(True), w)
    r_off = _window_residuals(p, x_prev, x_next, *args,
                              jnp.asarray(False), w)
    # the forward edge owns the final 6 residual slots
    assert np.any(np.asarray(r_on[-6:]) != 0.0)
    assert np.all(np.asarray(r_off[-6:]) == 0.0)
    np.testing.assert_array_equal(np.asarray(r_on[:-6]),
                                  np.asarray(r_off[:-6]))


def test_windowed_ba_reduces_global_energy(seeded_reference_world):
    import jax.numpy as jnp
    from icm_slam_tpu.models.bundle_adjustment import BAProblem, energy
    from icm_slam_tpu.models.windowed_ba import _solve_windows
    from icm_slam_tpu.solver.icm import _filter_jit, _init_jit, prepare, seed_map

    ds = seeded_reference_world.slice(200)
    # obs_cap at or above every frame's valid-beam count (27 here), so
    # the compacted observations hold the whole energy
    cfg = ICMConfig(N=1, L=256, dtype="float32", ba_gn_iters=4, obs_cap=32)
    data = prepare(ds, cfg)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    st, x, _ = _init_jit(data, seed_map(data, x0, cfg), x0, cfg)
    cur = _filter_jit(st, cfg)
    w = weights(cfg)
    labels, fmap, matched = batched_associate(data, cur, x, cfg)
    L = cur.pos.shape[0]
    prob = BAProblem(data, data.dist,
                     jnp.broadcast_to(data.ang, data.dist.shape), labels,
                     ((labels < L) & data.mask).astype(x.dtype),
                     fmap.counts, fmap.counts > 0)
    from icm_slam_tpu.solver.sweeps import compact_obs
    obs = compact_obs(data, matched, cfg.obs_cap)
    # the init is the causal scan's fixed point, which the windows barely
    # move: start them from its poses shifted by up to 5 cm
    shift = np.random.default_rng(0).uniform(-0.05, 0.05, (ds.T - 1, 2))
    x = x.at[1:, :2].add(jnp.asarray(shift, x.dtype))
    e0 = float(energy(x, fmap.pos, prob, w))
    x1 = _solve_windows(data, obs, x, 0, 64, ds.T - 1, cfg, w)
    x2 = _solve_windows(data, obs, x1, 32, 64, ds.T - 1, cfg, w)
    assert float(energy(x2, fmap.pos, prob, w)) < e0


def test_compact_data_association_equivalence(seeded_reference_world):
    """batched_associate on compact_data'd inputs == full-width inputs.

    The beam compaction reorders each frame's valid beams to the front; the
    final map, live count, and the matched running-mean value of every valid
    beam must be unchanged (solver.sweeps.compact_data exactness contract).
    """
    import jax.numpy as jnp
    from icm_slam_tpu.solver.icm import _filter_jit, _init_jit, prepare, seed_map
    from icm_slam_tpu.solver.sweeps import auto_obs_cap, compact_data

    ds = seeded_reference_world.slice(250)
    cfg = ICMConfig(N=1, L=256, dtype="float32")
    data = prepare(ds, cfg)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    st, x, _ = _init_jit(data, seed_map(data, x0, cfg), x0, cfg)
    cur = _filter_jit(st, cfg)

    cap = auto_obs_cap(data.mask)
    data_c = compact_data(data, cap)
    _, map_full, matched_full = batched_associate(data, cur, x, cfg)
    _, map_comp, matched_comp = batched_associate(data_c, cur, x, cfg)

    assert int(map_full.nact) == int(map_comp.nact)
    np.testing.assert_allclose(np.asarray(map_full.pos),
                               np.asarray(map_comp.pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(map_full.counts),
                               np.asarray(map_comp.counts), atol=1e-5)

    # matched values at valid beams match after applying the same gather
    order = np.argsort(~np.asarray(data.mask), axis=1, kind="stable")[:, :cap]
    mf = np.take_along_axis(np.asarray(matched_full), order[..., None], axis=1)
    mask_c = np.asarray(data_c.mask)
    np.testing.assert_allclose(mf[mask_c], np.asarray(matched_comp)[mask_c],
                               atol=1e-5)
