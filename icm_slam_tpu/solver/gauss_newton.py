"""Levenberg-Marquardt minimizer for small per-pose problems.

Replaces the reference's per-pose Nelder-Mead simplex (scipy fmin, xtol=1e-3;
ICM_ROS.py:217,259) with a damped Gauss-Newton iteration — the
accelerator-friendly choice: fixed iteration count, fully batchable with
vmap over thousands of poses, and it converges far tighter than the
simplex on these near-quadratic 3-dof costs (only the heading enters
nonlinearly).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def _solve3(A, rhs):
    """Closed-form 3x3 linear solve (adjugate / determinant).

    The generic jnp.linalg.solve lowers to an LU pipeline of several
    kernels; for the 3-dof pose Hessian a cofactor expansion is exact,
    branch-free, and fuses into the surrounding LM step.
    """
    c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
    c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
    c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
    det = A[0, 0] * c00 + A[0, 1] * c01 + A[0, 2] * c02
    c10 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
    c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
    c12 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
    c20 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
    c21 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
    c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    b0, b1, b2 = rhs[0], rhs[1], rhs[2]
    # element-wise adjugate application (no (3,3) materialization: scalar
    # stacking inside the sequential init scan measured slower)
    return jnp.stack([c00 * b0 + c10 * b1 + c20 * b2,
                      c01 * b0 + c11 * b1 + c21 * b2,
                      c02 * b0 + c12 * b1 + c22 * b2]) / det


def lm_minimize(resid_fn, x0, iters=12, lam0=1e-4, lam_down=0.25,
                lam_up=8.0, jac_fn=None, closed_form=True):
    """Minimize sum(resid_fn(x)**2) over x (n,) with adaptive damping.

    resid_fn: x -> (m,) residual vector.  Fixed ``iters`` LM steps
    (Marquardt diagonal scaling) with accept/reject via jnp.where —
    compiles to a single fused loop, vmappable over batches of problems.
    jac_fn: optional analytic Jacobian x -> (m, n); default jacfwd.
    closed_form: use the cofactor 3x3 solve for n == 3 (one fused step
    instead of an LU pipeline of several kernels inside vmapped batches);
    sequential lax.scan bodies pass False.  Neither choice is measured on
    the GPU yet.
    """
    n = x0.shape[0]
    eye = jnp.eye(n, dtype=x0.dtype)
    if jac_fn is None:
        jac_fn = jax.jacfwd(resid_fn)

    # the residual at the ACCEPTED point rides the carry: the trial
    # point's residual doubles as the next iteration's linearization
    # residual on accept, so each LM step evaluates resid_fn once, not
    # twice (bitwise-identical — the same deterministic value either way)
    def step(carry, _):
        x, lam, fx, r = carry
        J = jac_fn(x)
        # HIGHEST: at default precision a GPU may run these float32 dots
        # (hundreds of beam terms each) in TF32, which moves the solved
        # poses by millimetres
        g = jnp.matmul(J.T, r, precision=_HIGHEST)
        H = jnp.matmul(J.T, J, precision=_HIGHEST)
        damp = jnp.diag(jnp.maximum(jnp.diag(H), 1e-12))
        A = H + lam * damp + 1e-12 * eye
        delta = (_solve3(A, -g) if closed_form and n == 3
                 else jnp.linalg.solve(A, -g))
        x_new = x + delta
        r_new = resid_fn(x_new)
        f_new = jnp.sum(r_new * r_new)
        better = f_new < fx
        x = jnp.where(better, x_new, x)
        fx = jnp.where(better, f_new, fx)
        r = jnp.where(better, r_new, r)
        lam = jnp.where(better, lam * lam_down, lam * lam_up)
        return (x, lam, fx, r), None

    # NOTE: unroll=True blows up the fused sweep jit's compile time (the
    # CPU suite went from 245 s to over 420 s); keep the rolled scan.
    r0 = resid_fn(x0)
    (x, _, _, _), _ = jax.lax.scan(
        step, (x0, jnp.asarray(lam0, x0.dtype), jnp.sum(r0 * r0), r0),
        None, length=iters)
    return x
