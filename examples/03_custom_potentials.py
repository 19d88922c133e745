"""Custom energy hooks — the reference's example.py subclass mechanism.

    python examples/03_custom_potentials.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp

from icm_slam_tpu import ICMConfig
from icm_slam_tpu.core.energy import EnergyModel
from icm_slam_tpu.data.datasets import load
from icm_slam_tpu.solver.icm import run


def range_weighted_h(dist, ang):
    """Downweight long-range beams (sensor noise grows with distance)."""
    return 1.0 / (1.0 + 0.1 * dist)


def soft_odometry_anchor(x, prob):
    """Extra residual pulling each pose toward raw odometry."""
    return 0.5 * (x[:2] - prob.odo_cur[:2])


model = EnergyModel(obs_scale=range_weighted_h,
                    extra_one_sided=soft_odometry_anchor,
                    extra_two_sided=soft_odometry_anchor)

ds = load("reference").slice(600)
res = run(ds, ICMConfig(N=5, model=model), verbose=True)
print(f"custom-model run: {res.map_pos.shape[0]} landmarks")


# --- full replacement (the reference's fun_x_/h_ subclass override power) ---

def robust_obs_model(x, prob, sqrt_q):
    """REPLACE the whole observation potential h with a robust variant:
    Geman-McClure-style soft gating bounds each beam's influence."""
    a = prob.ang + x[2] - jnp.pi / 2.0
    pts = x[:2][None, :] + prob.dist[:, None] * jnp.stack(
        [jnp.cos(a), jnp.sin(a)], axis=-1)
    r = (pts - prob.matched) * sqrt_q[None, :]
    n2 = jnp.sum(r * r, axis=-1, keepdims=True)
    return jnp.where(prob.mask[:, None], r / jnp.sqrt(1.0 + n2), 0.0)


robust = EnergyModel(obs_model=robust_obs_model)
res2 = run(ds, ICMConfig(N=5, model=robust), verbose=True)
print(f"robust-h run: {res2.map_pos.shape[0]} landmarks")
