"""SE(2) pose-graph optimization with loop closures.

A second backend family beyond the ICM coordinate-descent solver (BASELINE
config 4: "pose-graph backend with loop closures on synthetic long-loop 2D
trajectories").  The reference has no counterpart — its MRF is solved only
by per-pose sweeps — so this is a from-scratch accelerator design:

* the graph is a fixed-shape edge list (i, j, rel SE(2) measurement, weight);
* Gauss-Newton outer iterations; the normal system H dx = -g is solved
  MATRIX-FREE with preconditioned conjugate gradients:
    - residuals of all edges evaluated in one vmapped batch,
    - H v = J^T (J v) via one jvp + one vjp of the stacked residual map
      (no Jacobian materialization),
    - block-Jacobi preconditioner from per-edge 3x3 diagonal blocks
      accumulated with segment_sum;
* everything is jnp over (E, ...) / (T, ...) arrays -> shards over edges
  and nodes with the same GSPMD machinery as the ICM sweep.

Node 0 is gauge-fixed (anchored).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from icm_slam_tpu.core.geometry import wrap_angle


class PoseGraph(NamedTuple):
    x: jnp.ndarray        # (T, 3) pose estimates
    edges_i: jnp.ndarray  # (E,) int32 source node
    edges_j: jnp.ndarray  # (E,) int32 target node
    rel: jnp.ndarray      # (E, 3) measured j-in-i [dx, dy, dtheta]
    weight: jnp.ndarray   # (E, 3) per-component residual weights (sqrt info)


def edge_residuals(x, g: PoseGraph):
    """(E, 3) weighted residuals.  r_xy = R(-th_i) (p_j - p_i) - t_ij,
    r_th = wrap(th_j - th_i - dth_ij)."""
    xi = x[g.edges_i]
    xj = x[g.edges_j]
    c, s = jnp.cos(xi[:, 2]), jnp.sin(xi[:, 2])
    dp = xj[:, :2] - xi[:, :2]
    local = jnp.stack([c * dp[:, 0] + s * dp[:, 1],
                       -s * dp[:, 0] + c * dp[:, 1]], axis=1)
    r_xy = local - g.rel[:, :2]
    r_th = wrap_angle(xj[:, 2] - xi[:, 2] - g.rel[:, 2])
    return jnp.concatenate([r_xy, r_th[:, None]], axis=1) * g.weight


def _gauge_mask(T, dtype):
    m = jnp.ones((T, 3), dtype)
    return m.at[0].set(0.0)  # anchor node 0


def _hvp(x, g: PoseGraph, v):
    """Gauss-Newton H v = J^T J v, matrix-free, gauge-fixed."""
    mask = _gauge_mask(x.shape[0], x.dtype)
    f = lambda xx: edge_residuals(xx, g)
    _, jv = jax.jvp(f, (x,), (v * mask,))
    (_, vjp_fn) = jax.vjp(f, x)
    (hv,) = vjp_fn(jv)
    return hv * mask


def _block_jacobi(x, g: PoseGraph):
    """(T, 3, 3) inverse diagonal blocks of H (+ identity regularization)."""
    T = x.shape[0]

    def edge_blocks(i, j, rel, wgt):
        def fi(xi):
            xe = jnp.stack([xi, x[j]])
            ge = PoseGraph(xe, jnp.zeros(1, jnp.int32),
                           jnp.ones(1, jnp.int32), rel[None], wgt[None])
            return edge_residuals(xe, ge)[0]

        def fj(xj):
            xe = jnp.stack([x[i], xj])
            ge = PoseGraph(xe, jnp.zeros(1, jnp.int32),
                           jnp.ones(1, jnp.int32), rel[None], wgt[None])
            return edge_residuals(xe, ge)[0]

        Ji = jax.jacfwd(fi)(x[i])
        Jj = jax.jacfwd(fj)(x[j])
        return Ji.T @ Ji, Jj.T @ Jj

    Bi, Bj = jax.vmap(edge_blocks)(g.edges_i, g.edges_j, g.rel, g.weight)
    diag = (jax.ops.segment_sum(Bi, g.edges_i, num_segments=T)
            + jax.ops.segment_sum(Bj, g.edges_j, num_segments=T))
    eye = jnp.eye(3, dtype=x.dtype)
    diag = diag + 1e-6 * eye[None]
    # anchor: make node 0's block identity (its updates are masked anyway)
    diag = diag.at[0].set(eye)
    return jnp.linalg.inv(diag)


def _pcg(hvp, b, minv, iters):
    """Preconditioned CG for H dx = b with block-diag preconditioner."""
    def apply_m(r):
        return jnp.einsum("tij,tj->ti", minv, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = apply_m(r0)
    p0 = z0

    def body(carry, _):
        x, r, z, p = carry
        hp = hvp(p)
        denom = jnp.vdot(p, hp)
        alpha = jnp.where(denom > 0, jnp.vdot(r, z) / denom, 0.0)
        x1 = x + alpha * p
        r1 = r - alpha * hp
        z1 = apply_m(r1)
        beta = jnp.where(jnp.vdot(r, z) > 0,
                         jnp.vdot(r1, z1) / jnp.vdot(r, z), 0.0)
        p1 = z1 + beta * p
        return (x1, r1, z1, p1), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, z0, p0), None, length=iters)
    return x


def optimize(g: PoseGraph, gn_iters=10, cg_iters=50, damping=1e-6):
    """Gauss-Newton with PCG inner solves. Returns (x, final residual norm)."""
    def gn_step(x, _):
        mask = _gauge_mask(x.shape[0], x.dtype)
        r = edge_residuals(x, g)
        f = lambda xx: edge_residuals(xx, g)
        (_, vjp_fn) = jax.vjp(f, x)
        (grad,) = vjp_fn(r)
        grad = grad * mask
        minv = _block_jacobi(x, g)
        hvp = lambda v: _hvp(x, g, v) + damping * v * mask
        dx = _pcg(hvp, -grad, minv, cg_iters)
        x_new = x + dx
        # keep the step only if it reduces the energy
        e_old = jnp.sum(r * r)
        e_new = jnp.sum(edge_residuals(x_new, g) ** 2)
        x = jnp.where(e_new < e_old, x_new, x)
        return x, jnp.sqrt(jnp.minimum(e_new, e_old))

    x, norms = jax.lax.scan(gn_step, g.x, None, length=gn_iters)
    return x, norms


def from_trajectory(x, odom_rel_noise=None, loop_pairs=None,
                    loop_rel=None, odo_weight=10.0, loop_weight=10.0):
    """Build a chain + loop-closure graph from a trajectory estimate.

    Chain edges connect consecutive poses with their current relative
    transform (or supplied noisy measurements); ``loop_pairs`` (K, 2) adds
    closure edges with measured relatives ``loop_rel`` (K, 3).
    """
    T = x.shape[0]
    ei = jnp.arange(0, T - 1, dtype=jnp.int32)
    ej = ei + 1
    rel = relative_se2(x[ei], x[ej]) if odom_rel_noise is None else \
        odom_rel_noise
    w = jnp.full((T - 1, 3), odo_weight, x.dtype)
    if loop_pairs is not None:
        li = jnp.asarray(loop_pairs[:, 0], jnp.int32)
        lj = jnp.asarray(loop_pairs[:, 1], jnp.int32)
        ei = jnp.concatenate([ei, li])
        ej = jnp.concatenate([ej, lj])
        rel = jnp.concatenate([rel, jnp.asarray(loop_rel, x.dtype)])
        w = jnp.concatenate(
            [w, jnp.full((li.shape[0], 3), loop_weight, x.dtype)])
    return PoseGraph(x, ei, ej, rel, w)


def relative_se2(xi, xj):
    """Measured relative pose of xj in xi's frame, (N, 3)."""
    c, s = jnp.cos(xi[..., 2]), jnp.sin(xi[..., 2])
    dp = xj[..., :2] - xi[..., :2]
    return jnp.stack([c * dp[..., 0] + s * dp[..., 1],
                      -s * dp[..., 0] + c * dp[..., 1],
                      wrap_angle(xj[..., 2] - xi[..., 2])], axis=-1)
