"""Loop-closure detection + pose-graph correction.

Completes the pose-graph backend (models/pose_graph.py) into an end-to-end
capability the reference lacks entirely: detect revisits from the lidar
scans themselves, estimate the relative pose by point registration, and
correct the trajectory with a pose-graph solve.

Pipeline:
  1. candidate pairs (host): frames far apart in time whose *estimated*
     poses are near in space;
  2. scan registration (device, vmapped over all candidates): 3-dof ICP —
     fixed-iteration nearest-point association + Levenberg-Marquardt on the
     SE(2) relative pose, masked fixed shapes throughout;
  3. gating: accept closures with enough inlier beams and low residual;
  4. pose-graph optimization: odometry chain edges + accepted closure edges
     (matrix-free Gauss-Newton + PCG).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icm_slam_tpu.core.geometry import wrap_angle
from icm_slam_tpu.models.pose_graph import (from_trajectory, optimize,
                                            relative_se2)
from icm_slam_tpu.solver.gauss_newton import lm_minimize
from icm_slam_tpu.solver.sweeps import SweepData


class LoopClosures(NamedTuple):
    pairs: np.ndarray     # (K, 2) frame indices (i, j)
    rel: np.ndarray       # (K, 3) estimated pose of j in i's frame
    inliers: np.ndarray   # (K,) inlier beam fraction
    rms: np.ndarray       # (K,) inlier residual RMS [m]


def _body_points(dist, ang, mask):
    """(B, 2) body-frame points of one scan (beam convention incl. -pi/2)."""
    a = ang - jnp.pi / 2.0
    pts = dist[:, None] * jnp.stack([jnp.cos(a), jnp.sin(a)], axis=-1)
    return pts, mask


def icp_register(pts_i, mask_i, pts_j, mask_j, rel0, icp_iters=8,
                 lm_iters=6, gate=1.0, coarse_gate=None):
    """Register scan j onto scan i. rel0: (3,) initial relative pose of j in
    i's frame. Returns (rel (3,), inlier_fraction, inlier_rms).

    When ``coarse_gate > gate`` the association gate anneals geometrically
    from ``coarse_gate`` down to ``gate`` across the fixed ICP iterations —
    a coarse-to-fine schedule that widens the convergence basin to several
    meters of initial error (a drifted revisit) while the final inlier
    verdict still uses the tight gate.  Default is ``coarse_gate == gate``
    (no annealing): with sparse point-landmark scans a wide early gate can
    alias onto the wrong landmark, so widening is an explicit, per-call
    decision.  The schedule is a static per-step input to the `lax.scan`,
    so the program stays fixed-shape.
    """
    B = pts_j.shape[0]
    if coarse_gate is None:
        coarse_gate = gate
    gates = jnp.geomspace(coarse_gate, gate, icp_iters).astype(pts_i.dtype)

    def transform(rel, p):
        c, s = jnp.cos(rel[2]), jnp.sin(rel[2])
        return jnp.stack([rel[0] + c * p[:, 0] - s * p[:, 1],
                          rel[1] + s * p[:, 0] + c * p[:, 1]], axis=-1)

    def nearest(q):
        """For each transformed j-point: nearest i-point + distance."""
        d = jnp.linalg.norm(q[:, None, :] - pts_i[None, :, :], axis=-1)
        d = jnp.where(mask_i[None, :], d, jnp.inf)
        return jnp.argmin(d, axis=1), jnp.min(d, axis=1)

    def icp_step(rel, g):
        q = transform(rel, pts_j)
        idx, dmin = nearest(q)
        ok = mask_j & (dmin < g) & jnp.isfinite(dmin)
        target = pts_i[jnp.clip(idx, 0, pts_i.shape[0] - 1)]

        def resid(r):
            qq = transform(r, pts_j)
            return ((qq - target) * ok[:, None]).reshape(-1)

        rel = lm_minimize(resid, rel, iters=lm_iters)
        return rel, None

    rel, _ = jax.lax.scan(icp_step, rel0, gates)
    q = transform(rel, pts_j)
    _, dmin = nearest(q)
    ok = mask_j & (dmin < gate) & jnp.isfinite(dmin)
    n_ok = jnp.sum(ok)
    frac = n_ok / jnp.maximum(jnp.sum(mask_j), 1)
    rms = jnp.sqrt(jnp.sum(jnp.where(ok, dmin ** 2, 0.0))
                   / jnp.maximum(n_ok, 1))
    return rel, frac, rms


def detect(data: SweepData, x, min_gap: int = 150, radius: float = 2.0,
           max_pairs: int = 64, min_inliers: float = 0.5,
           max_rms: float = 0.25, min_beams: int = 5,
           icp_gate: float = 1.0,
           icp_coarse_gate: Optional[float] = None) -> LoopClosures:
    """Find and verify loop closures on the current trajectory estimate."""
    xs = np.asarray(x)
    mask = np.asarray(data.mask)
    n_valid = mask.sum(1)
    T = xs.shape[0]

    # --- host-side candidate selection (greedy, spatially thinned) ---------
    cands = []
    taken = np.zeros(T, bool)
    order = np.arange(0, T, 5)
    for i in order:
        if n_valid[i] < min_beams:
            continue
        d = np.linalg.norm(xs[:, :2] - xs[i, :2], axis=1)
        js = np.where((np.arange(T) > i + min_gap) & (d < radius)
                      & (n_valid >= min_beams))[0]
        if js.size and not taken[i]:
            j = int(js[np.argmin(d[js])])
            cands.append((i, j))
            taken[max(0, i - 20):i + 20] = True
        if len(cands) >= max_pairs:
            break
    if not cands:
        empty = np.zeros((0,))
        return LoopClosures(np.zeros((0, 2), int), np.zeros((0, 3)),
                            empty, empty)

    pairs = np.asarray(cands, np.int32)

    # --- device-side batched ICP -------------------------------------------
    ii = jnp.asarray(pairs[:, 0])
    jj = jnp.asarray(pairs[:, 1])
    pts_all, _ = jax.vmap(
        lambda d, m: _body_points(d, data.ang, m))(data.dist, data.mask)
    rel0 = relative_se2(x[ii], x[jj])

    @jax.jit
    def register_all(pts_all, mask_all, rel0):
        return jax.vmap(
            lambda i, j, r0: icp_register(pts_all[i], mask_all[i],
                                          pts_all[j], mask_all[j], r0,
                                          gate=icp_gate,
                                          coarse_gate=icp_coarse_gate)
        )(ii, jj, rel0)

    rel, frac, rms = register_all(pts_all, data.mask, rel0)
    rel, frac, rms = np.asarray(rel), np.asarray(frac), np.asarray(rms)
    keep = (frac >= min_inliers) & (rms <= max_rms)
    return LoopClosures(pairs[keep], rel[keep], frac[keep], rms[keep])


def estimate_correctable_drift(x, odom, closures: LoopClosures
                               ) -> Tuple[float, float]:
    """Two revisit-disagreement signals [m], medians over the closures.

    Returns ``(d_x, d_odo)``:

    * ``d_x`` — |relative pose the CURRENT estimate predicts − ICP-measured
      relative|: how inconsistent the estimate itself is with the revisits.
      Large when raw drift was never corrected (e.g. ``x`` is odometry);
      near zero for an ICM estimate, whose shared landmark map makes both
      laps mutually consistent EVEN when the whole trajectory is warped
      (measured: 0.036 m at 0.064 m ICM ATE and 0.034 m at 0.506 m ICM
      ATE — this signal alone cannot see the warp).
    * ``d_odo`` — |odometry-chain relative − ICP-measured relative|: the
      accumulated odometry drift between visit and revisit.  This is what
      the pose-graph solve (odometry chain edges + closure edges) actually
      corrects, and it scales with the warp an odometry-prior-driven
      estimate inherits (measured ≈0.25-0.35 of it).
    """
    ii = closures.pairs[:, 0]
    jj = closures.pairs[:, 1]
    rel = np.asarray(closures.rel)[:, :2]
    pred_x = np.asarray(relative_se2(x[ii], x[jj]))[:, :2]
    pred_o = np.asarray(relative_se2(odom[ii], odom[jj]))[:, :2]
    d_x = float(np.median(np.linalg.norm(pred_x - rel, axis=1)))
    d_odo = float(np.median(np.linalg.norm(pred_o - rel, axis=1)))
    return d_x, d_odo


def close_loops(data: SweepData, x, config, closures: Optional[LoopClosures]
                = None, odo_weight: float = 5.0, loop_weight: float = 20.0,
                gn_iters: int = 10, cg_iters: int = 200, rounds: int = 1,
                min_drift: float = 0.15, drift_gate_rms: float = 3.5,
                odo_drift_frac: float = 0.3,
                report: Optional[dict] = None,
                **detect_kw) -> Tuple[jnp.ndarray, LoopClosures]:
    """Detect closures (unless given) and pose-graph-correct the trajectory.

    Chain edges use the raw odometry's relative motions as measurements;
    closure edges use the ICP-estimated relatives.  Returns (x_corrected,
    closures of the final round).

    **Regime guard**: correction is applied only when the
    estimated correctable drift ``max(d_x, odo_drift_frac * d_odo)``
    (see `estimate_correctable_drift`) exceeds
    ``max(min_drift, drift_gate_rms * median closure RMS)`` — the latter
    approximating the pose-graph solution's own error floor (measured
    ~0.21 m at ~0.06 m closure RMS on the drifted worlds).  Below the gate
    the graph solve would *substitute* its noisier reconstruction for an
    already-better estimate (measured: 0.064 m ICM ATE regressed to
    0.21-0.26 m) — so the round no-ops.  Both regimes
    were measured to calibrate the defaults: skip at d_odo 0.28 m /
    ICM 0.064 m, apply at d_odo 1.40 m / ICM 0.506 m (2.3x gain).
    ``min_drift=0`` disables the guard.  Pass a dict as ``report`` to
    receive per-round guard decisions (``report["rounds"]``: applied /
    est_drift_m / gate_m / d_x_m / d_odo_m / noise_rms_m / n_closures).

    ``rounds > 1`` iterates detect -> correct: each correction shrinks the
    remaining drift, which pulls more revisit candidates inside the search
    radius and the ICP convergence basin, so later rounds verify closures
    the first pass could not (measured on the drifted two-lap world:
    10 -> 25 -> 29 accepted closures, ATE 2.24 -> 1.74 -> 1.67 m;
    benchmarks/loop_closure_eval.py).  Detection is host-side, so rounds
    stay a Python loop.  If ``closures`` is given it seeds round 1;
    later rounds re-detect.
    """
    odo = data.odom
    odom_rel = relative_se2(odo[:-1], odo[1:])
    last = None
    rows = [] if report is None else report.setdefault("rounds", [])
    for _ in range(max(rounds, 1)):
        if closures is None:
            closures = detect(data, x, **detect_kw)
        if closures.pairs.shape[0] == 0:
            # a dry later round must not discard the closures that WERE
            # applied — return the last applied set
            return x, (closures if last is None else last)
        noise = float(np.median(closures.rms))
        # min_drift <= 0 is the documented kill-switch: no gate at all
        # (not even the noise-floor term — otherwise "disable" would
        # silently keep gating on drift_gate_rms * noise)
        gate = 0.0 if min_drift <= 0 else max(min_drift,
                                              drift_gate_rms * noise)
        d_x, d_odo = estimate_correctable_drift(x, odo, closures)
        est_drift = max(d_x, odo_drift_frac * d_odo)
        # the guard protects a good INCOMING estimate (round 1 only):
        # once a round has applied, x is the graph's own half-converged
        # reconstruction and the remaining rounds iterate it toward
        # convergence — gating them strands a transiently-worse state
        # (measured: round 1 alone 0.59 -> 1.51 m ATE, round 2 recovers
        # to < 0.35; tests/test_loop_closure.py iterated-rounds)
        guarded = last is None
        apply = (not guarded) or est_drift >= gate
        row = {"n_closures": int(closures.pairs.shape[0]),
               "est_drift_m": round(est_drift, 4),
               "gate_m": round(gate, 4),
               "d_x_m": round(d_x, 4), "d_odo_m": round(d_odo, 4),
               "noise_rms_m": round(noise, 4),
               "guarded": guarded,
               "applied": apply}
        rows.append(row)
        if not apply:
            # below the measurement-noise floor: a no-op protects the
            # estimate; the detected (unapplied) set is still returned so
            # callers can inspect it
            return x, closures
        g = from_trajectory(x, odom_rel_noise=odom_rel,
                            loop_pairs=closures.pairs,
                            loop_rel=jnp.asarray(closures.rel, x.dtype),
                            odo_weight=odo_weight, loop_weight=loop_weight)
        x, _ = optimize(g, gn_iters=gn_iters, cg_iters=cg_iters)
        last = closures
        closures = None
    return x, last
