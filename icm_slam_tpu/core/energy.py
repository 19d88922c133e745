"""Per-pose energy terms as weighted least-squares residuals.

The reference minimizes two scalar costs per pose with Nelder-Mead:
one-sided fun_x (ICM_ROS.py:262-278) for the causal sweep / last frame, and
the symmetric two-sided fun_xn (ICM_ROS.py:220-252) for interior poses of the
refinement sweep.  Both are sums of squares, so here they are expressed as
*residual vectors* r(x) with the property  energy(x) == sum(r(x)**2)  — the
form a Gauss-Newton / Levenberg-Marquardt solver consumes directly.

Terms (weights folded in as square roots):
  kinematic   sqrt(R) * wrap(x - g(x_prev, u_prev))
  observation sqrt(Q) * mask * (world_point(x, beam) - matched_landmark)
  odometry    sqrt(cte_odom) * relative-displacement residual (Eq.16 form)

Observation residuals are masked fixed-shape (B beams); masked-out beams
contribute exact zeros, matching the reference's variable-length sums.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from icm_slam_tpu.core.geometry import rot2, unicycle_step, wrap_angle


class PoseProblem(NamedTuple):
    """Data defining one pose's local cost (all fixed-shape, batchable).

    For the one-sided cost, the *_next fields are ignored (pass zeros).
    """
    dist: jnp.ndarray      # (B,) filtered beam ranges
    ang: jnp.ndarray       # (B,) beam angles [rad]
    mask: jnp.ndarray      # (B,) informative-beam mask
    matched: jnp.ndarray   # (B, 2) associated landmark positions
    x_prev: jnp.ndarray    # (3,)
    u_prev: jnp.ndarray    # (2,) control at t-1
    odo_prev: jnp.ndarray  # (3,) odometry at t-1
    odo_cur: jnp.ndarray   # (3,) odometry at t
    x_next: jnp.ndarray    # (3,)
    u_cur: jnp.ndarray     # (2,) control at t
    odo_next: jnp.ndarray  # (3,) odometry at t+1


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """User-extensible energy definition.

    The reference exposes subclass hooks g/h/fun_x/fun_xn for users to
    swap the kinematic model and potentials wholesale (example.py:13-35,
    external_options.py:17-35; base definitions ICM_ROS.py:171-278).  The
    equivalent here is functional: pass replacement callables here;
    every hook must be jittable.  Costs are expressed as RESIDUAL VECTORS
    r with energy == sum(r**2) — the form the vmapped LM solver consumes
    (any quadratic-form potential, like every cost in the reference,
    decomposes this way exactly).

    Elementwise tweaks (compose with the default terms):
      kinematics(x, u, deltat) -> (3,)      replaces g (ICM_ROS.py:202-207)
      obs_scale(dist, ang) -> (B,)           per-beam residual scaling
                                              (elementwise h reweighting)
      extra_one_sided(x, prob) -> (k,)       extra residuals added to fun_x
      extra_two_sided(x, prob) -> (k,)       extra residuals added to fun_xn

    Full replacements (the reference's subclass-override power):
      obs_model(x, prob, sqrt_q) -> (k,)     replaces the WHOLE observation
                                              potential h (ICM_ROS.py:171-200);
                                              must mask invalid beams itself
                                              (prob.mask) and return a fixed
                                              shape
      one_sided(x, prob, w) -> (k,)          replaces fun_x entirely
                                              (ICM_ROS.py:262-278)
      two_sided(x, prob, w) -> (k,)          replaces fun_xn entirely
                                              (ICM_ROS.py:220-252)

    ``w`` is the weights() tuple (sqrt_r, sqrt_q, sqrt_odom, deltat).  A
    full replacement can call the default builders (one_sided_residuals /
    two_sided_residuals with DEFAULT_MODEL) to reuse pieces.

    Instances are hashable by identity -> usable as a jit-static config
    field; reuse one instance across calls to avoid recompilation.
    """
    kinematics: Callable = unicycle_step
    obs_scale: Optional[Callable] = None
    extra_one_sided: Optional[Callable] = None
    extra_two_sided: Optional[Callable] = None
    obs_model: Optional[Callable] = None
    one_sided: Optional[Callable] = None
    two_sided: Optional[Callable] = None

    def __hash__(self):
        return hash(tuple(id(getattr(self, f.name))
                          for f in dataclasses.fields(self)))


DEFAULT_MODEL = EnergyModel()


def _odo_residual(th_anchor, odo0, odo1, dxy, dth):
    """Relative-displacement odometry residual (ICM_ROS.py:272-277).

    rot2(odo0_theta) @ (odo1_xy - odo0_xy) - rot2(th_anchor) @ dxy, plus the
    wrapped heading increment mismatch.
    """
    hi = jax.lax.Precision.HIGHEST  # no TF32 rounding on a GPU
    rxy = (jnp.matmul(rot2(odo0[2]), odo1[:2] - odo0[:2], precision=hi)
           - jnp.matmul(rot2(th_anchor), dxy, precision=hi))
    rth = wrap_angle(odo1[2] - odo0[2] - dth)
    return jnp.concatenate([rxy, rth[None]])


def obs_residuals(x, p: PoseProblem, sqrt_q, model: EnergyModel = DEFAULT_MODEL):
    """(B, 2) masked observation residuals (h potential, ICM_ROS.py:171-200)."""
    if model.obs_model is not None:
        return model.obs_model(x, p, sqrt_q)
    a = p.ang + x[2] - jnp.pi / 2.0
    pts = x[:2][None, :] + p.dist[:, None] * jnp.stack(
        [jnp.cos(a), jnp.sin(a)], axis=-1)
    r = (pts - p.matched) * sqrt_q[None, :]
    if model.obs_scale is not None:
        r = r * model.obs_scale(p.dist, p.ang)[:, None]
    return jnp.where(p.mask[:, None], r, 0.0)


def one_sided_residuals(x, p: PoseProblem, w,
                        model: EnergyModel = DEFAULT_MODEL):
    """Residuals of fun_x (ICM_ROS.py:262-278). w = (sqrt_r, sqrt_q, sqrt_odom)."""
    if model.one_sided is not None:
        return model.one_sided(x, p, w)
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    gg = x - model.kinematics(p.x_prev, p.u_prev, deltat)
    gg = gg.at[2].set(wrap_angle(gg[2]))
    r_kin = sqrt_r * gg
    r_obs = obs_residuals(x, p, sqrt_q, model)
    r_odo = sqrt_odom * _odo_residual(
        p.x_prev[2], p.odo_prev, p.odo_cur, x[:2] - p.x_prev[:2],
        x[2] - p.x_prev[2])
    parts = [r_kin, r_obs.reshape(-1), r_odo]
    if model.extra_one_sided is not None:
        parts.append(model.extra_one_sided(x, p))
    return jnp.concatenate(parts)


def two_sided_residuals(x, p: PoseProblem, w,
                        model: EnergyModel = DEFAULT_MODEL):
    """Residuals of fun_xn (ICM_ROS.py:220-252): forward + backward terms."""
    if model.two_sided is not None:
        return model.two_sided(x, p, w)
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    ggf = model.kinematics(x, p.u_cur, deltat) - p.x_next
    ggf = ggf.at[2].set(wrap_angle(ggf[2]))
    r_kinf = sqrt_r * ggf
    r_odof = sqrt_odom * _odo_residual(
        x[2], p.odo_cur, p.odo_next, p.x_next[:2] - x[:2],
        p.x_next[2] - x[2])
    parts = [r_kinf, r_odof, one_sided_residuals(x, p, w, model)]
    if model.extra_two_sided is not None:
        parts.append(model.extra_two_sided(x, p))
    return jnp.concatenate(parts)


def one_sided_jacobian(x, p: PoseProblem, w):
    """Analytic Jacobian of one_sided_residuals wrt x (rows in the same
    stacking order). Valid for the DEFAULT model only (unicycle kinematics,
    unscaled h, no extra residuals); solvers fall back to jacfwd otherwise.

    Derivatives: the kinematic term is identity in x (wrap has unit slope);
    each observation row depends on (x, y) identically and on theta through
    the beam direction; the odometry xy-block is the constant -R(theta_prev)
    and its heading row is -1.
    """
    sqrt_r, sqrt_q, sqrt_odom, _ = w
    B = p.dist.shape[0]
    dtype = x.dtype

    j_kin = jnp.diag(sqrt_r)

    a = p.ang + x[2] - jnp.pi / 2.0
    dsin = p.dist * jnp.sin(a)
    dcos = p.dist * jnp.cos(a)
    zeros = jnp.zeros((B,), dtype)
    ones = jnp.ones((B,), dtype)
    m = p.mask.astype(dtype)
    # rows interleave (r_x, r_y) per beam: obs residuals reshape to (-1)
    jx = jnp.stack([ones, zeros, -dsin], axis=1) * (sqrt_q[0] * m)[:, None]
    jy = jnp.stack([zeros, ones, dcos], axis=1) * (sqrt_q[1] * m)[:, None]
    j_obs = jnp.stack([jx, jy], axis=1).reshape(2 * B, 3)

    c, s = jnp.cos(p.x_prev[2]), jnp.sin(p.x_prev[2])
    j_odo = sqrt_odom * jnp.asarray(
        [[-c, -s, 0.0], [s, -c, 0.0], [0.0, 0.0, -1.0]], dtype)

    return jnp.concatenate([j_kin, j_obs, j_odo], axis=0)


def two_sided_jacobian(x, p: PoseProblem, w):
    """Analytic Jacobian of two_sided_residuals (forward + backward rows)."""
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    dtype = x.dtype
    v = p.u_cur[0]
    c, s = jnp.cos(x[2]), jnp.sin(x[2])

    # forward kinematic: d g(x,u)/dx = I + dt*[[0,0,-v s],[0,0,v c],[0,0,0]]
    j_kinf = sqrt_r[:, None] * jnp.asarray(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype
    ).at[0, 2].set(-deltat * v * s).at[1, 2].set(deltat * v * c)

    # forward odometry: rxy = meas - R(th)(xn - x); R = [[c,s],[-s,c]]
    dxy = p.x_next[:2] - x[:2]
    # d/dx_xy (-R d) = +R; d/dth = -R' d, R' = [[-s,c],[-c,-s]]
    dRd = jnp.asarray([-s * dxy[0] + c * dxy[1],
                       -c * dxy[0] - s * dxy[1]], dtype)
    j_odof = sqrt_odom * jnp.asarray(
        [[c, s, -dRd[0]], [-s, c, -dRd[1]], [0.0, 0.0, 1.0]], dtype)

    j_back = one_sided_jacobian(x, p, (sqrt_r, sqrt_q, sqrt_odom, deltat))
    return jnp.concatenate([j_kinf, j_odof, j_back], axis=0)


def weights(config):
    """Precompute sqrt weights tuple from an ICMConfig."""
    dtype = jnp.dtype(config.dtype)
    sqrt_r = jnp.sqrt(jnp.asarray(config.R, dtype))
    sqrt_q = jnp.sqrt(jnp.asarray(config.Q, dtype))
    sqrt_odom = jnp.sqrt(jnp.asarray(config.cte_odom, dtype))
    return sqrt_r, sqrt_q, sqrt_odom, config.deltat


def energy(residuals):
    return jnp.sum(residuals * residuals)
