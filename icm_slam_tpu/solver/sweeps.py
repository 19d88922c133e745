"""ICM sweep engines: causal init, sequential refine, batched refine.

Three sweeps over the trajectory:

* ``init_sweep`` — ICM iteration 0 (ICM_ROS.py:47-119): causal, the map grows
  as frames arrive, each pose chains on the previous one.  Inherently
  sequential -> lax.scan with the (map, pose) carry.

* ``refine_sweep_sequential`` — faithful Gauss-Seidel sweep
  (ICM_ROS.py:121-164): pose t uses *fresh* x[t-1] and *stale* x[t+1]; the
  accumulating map feeds running means to the cost.  lax.scan carrying the
  full pose array.  This mode exists for fidelity validation (matches the
  oracle's update order exactly).

* ``refine_sweep_batched`` — the parallel mode.  Key observations about the
  reference semantics that make it parallel:
    - association at frame t uses the STALE pose x[t] and the FROZEN previous
      map (ICM_ROS.py:149-150) -> all T associations batch into one masked
      distance/argmin pass;
    - the matched map value read back is the RUNNING weighted mean up to
      frame t (y evolves during the sweep) -> an inclusive cumulative
      segment-sum over frames reproduces it EXACTLY;
    - new-landmark label allocation is one label per frame-with-far-obs
      (the ICM_SLAM.py:176 quirk) -> a cumsum of frame flags;
    - the only remaining sequential coupling is x[t-1]/x[t+1] in the pose
      cost -> red-black Gauss-Seidel half-passes, each updating ~T/2 poses in
      one vmapped LM solve.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from icm_slam_tpu.core.energy import (DEFAULT_MODEL, PoseProblem,
                                      one_sided_jacobian,
                                      one_sided_residuals,
                                      two_sided_jacobian,
                                      two_sided_residuals)
from icm_slam_tpu.core.geometry import beams_to_world
from icm_slam_tpu.mapping.landmark_map import (MapState, associate, update)
from icm_slam_tpu.solver.gauss_newton import lm_minimize

# a chunk of the batched init has settled when a Picard round changes no
# label and, in this round and the last, no pose coordinate by more than
# this (m, rad)
PICARD_TOL = 1e-5


def _model_of(config):
    """Resolve the (possibly user-supplied) EnergyModel for a config."""
    return config.model if config.model is not None else DEFAULT_MODEL


def _jacs_of(config):
    """Jacobian choice for the LM solves.

    Analytic Jacobians (core.energy.one/two_sided_jacobian) are exact and
    validated, but XLA evaluates the 3-tangent JVP batch of jacfwd in one
    fused pass, while the hand-built J stacks many small ops per LM step.
    jacfwd (None) is therefore the default; flip here to experiment.
    """
    return None, None


class SweepData(NamedTuple):
    """Pre-filtered dataset, fixed shapes. T frames x B beams."""
    dist: jnp.ndarray   # (T, B) median-filtered ranges
    mask: jnp.ndarray   # (T, B) informative-beam mask
    ang: jnp.ndarray    # (B,) beam angles
    odom: jnp.ndarray   # (T, 3) odometry poses
    u: jnp.ndarray      # (T, 2) controls [v, omega]


def _zeros3(dtype):
    return jnp.zeros((3,), dtype)


def _problem_one_sided(data: SweepData, t, matched, x_prev):
    z = _zeros3(data.odom.dtype)
    return PoseProblem(
        dist=data.dist[t], ang=data.ang, mask=data.mask[t], matched=matched,
        x_prev=x_prev, u_prev=data.u[t - 1], odo_prev=data.odom[t - 1],
        odo_cur=data.odom[t], x_next=z, u_cur=jnp.zeros((2,), z.dtype),
        odo_next=z)


# ---------------------------------------------------------------------------
# causal init sweep (ICM iteration 0)
# ---------------------------------------------------------------------------

def _causal_step(data: SweepData, config, w):
    """One frame of the causal init (ICM_ROS.py:102-119) as a scan body.

    carry = (map_state, previous pose); step input = (frame arrays, prev
    control/odometry) so the same body serves the whole-dataset sweep and
    the online chunked stream.
    """
    dist_thr = config.dist_thr
    quirk = config.replicate_new_obs_quirk
    model = _model_of(config)
    jac1, _ = _jacs_of(config)

    cap = config.obs_cap or 0

    def step(carry, inp):
        state, xt = carry
        dist_t, mask_t, ang_t, u_prev, odo_prev, odo_cur = inp
        xtc = model.kinematics(xt, u_prev, config.deltat)
        empty = ~jnp.any(mask_t)
        pts = beams_to_world(xtc, dist_t, ang_t)
        new_state, labels = update(state, state.pos, state.nact, pts,
                                   mask_t, dist_thr, quirk)
        matched = new_state.pos[jnp.clip(labels, 0, state.pos.shape[0] - 1)]
        dist_p, ang_p, mask_p, matched_p = dist_t, ang_t, mask_t, matched
        if cap and cap < mask_t.shape[0]:
            # gather the few valid beams for the pose solve (exact when
            # cap >= the frame's valid count — see auto_obs_cap).
            # cumsum-scatter instead of argsort: no sort inside the
            # scan body.
            B = mask_t.shape[0]
            rank = jnp.cumsum(mask_t) - 1
            tgt = jnp.where(mask_t & (rank < cap), rank, cap)
            order = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(
                jnp.arange(B, dtype=jnp.int32))[:cap]
            n_valid = jnp.sum(mask_t)
            mask_p = jnp.arange(cap) < n_valid
            dist_p, ang_p, matched_p = (dist_t[order], ang_t[order],
                                        matched[order])
        z3 = jnp.zeros((3,), xt.dtype)
        prob = PoseProblem(
            dist=dist_p, ang=ang_p, mask=mask_p, matched=matched_p,
            x_prev=xt, u_prev=u_prev, odo_prev=odo_prev, odo_cur=odo_cur,
            x_next=z3, u_cur=jnp.zeros((2,), xt.dtype), odo_next=z3)
        x_opt = lm_minimize(
            lambda x: one_sided_residuals(x, prob, w, model), xtc,
            iters=config.pose_gn_iters,
            jac_fn=None if jac1 is None else
            (lambda x: jac1(x, prob, w)), closed_form=False)
        x_new = jnp.where(empty, xtc, x_opt)
        return (new_state, x_new), x_new

    return step


def init_chunk(data: SweepData, state: MapState, xt, config, w, t_offset=1
               ) -> Tuple[MapState, jnp.ndarray, jnp.ndarray]:
    """Causal init over the frames t_offset..T-1 of ``data``, from carry
    (state, xt). Returns (state, last pose, poses for those frames)."""
    step = _causal_step(data, config, w)
    T = data.dist.shape[0]
    ang = (data.ang if data.ang.ndim == 2
           else jnp.broadcast_to(data.ang, data.dist.shape))
    inputs = (data.dist[t_offset:], data.mask[t_offset:], ang[t_offset:],
              data.u[t_offset - 1:T - 1], data.odom[t_offset - 1:T - 1],
              data.odom[t_offset:])
    (state, xt), xs = jax.lax.scan(step, (state, xt), inputs)
    return state, xt, xs


def init_sweep(data: SweepData, seed: MapState, x0, config, w
               ) -> Tuple[MapState, jnp.ndarray, jnp.ndarray]:
    """Run the causal initialization over frames 1..T-1.

    ``seed`` is the map after frame 0 (host-side first-frame clustering,
    ICM_SLAM.py:160-165). Returns (map_state, poses (T,3), raw_nact) where
    ``raw_nact`` is the raw allocated-label count — the table-overflow
    witness (> L means labels aliased the discard slot and observations
    were silently dropped; solver.icm.check_table_overflow).
    """
    cap = config.obs_cap or 0
    if cap and cap < data.dist.shape[1]:
        # per-frame association inside the scan drops from (181, L) to
        # (cap, L) distances — exact, see compact_data
        data = compact_data(data, cap)
    state, _, xs = init_chunk(data, seed, x0, config, w, t_offset=1)
    x = jnp.concatenate([x0[None, :], xs], axis=0)
    return state, x, state.nact


# ---------------------------------------------------------------------------
# batched (Picard) init sweep — parallel ICM iteration 0
# ---------------------------------------------------------------------------

def resolve_init_merge_cap(config) -> int:
    """Static width of the batched init's final duplicate merge.

    ``init_merge_cap``: -1 follows ``map_run_cap`` (the resolved value),
    0 disables (full L), >0 is explicit.  The merge runs at cota=0 —
    every allocated label survives into the compaction — so a cap-sliced
    merge is exact iff the raw allocated-label count stays <= cap; the
    caller must witness that (run() checks the init witness and errors,
    pointing at init_merge_cap=0)."""
    cap = (config.map_run_cap if config.init_merge_cap < 0
           else config.init_merge_cap)
    return cap if 0 < cap < config.L else 0


def init_sweep_batched(data: SweepData, seed: MapState, x0, config, w
                       ) -> Tuple[MapState, jnp.ndarray, jnp.ndarray]:
    """Causal init (ICM_ROS.py:47-119) as a chunked-Picard sweep.

    Returns (merged map_state, poses (T,3), raw_nact): ``raw_nact`` is the
    PRE-merge allocated-label count (the in-function duplicate merge caps
    state.nact at <= L, so only the raw count can witness table overflow).

    The sequential init is a T-step lax.scan whose per-step LM solve
    dominates wall time (a sequential chain of ~15k tiny kernels at
    T=1833).  The
    causal drift-correction the init performs cannot be globally batched
    (a pose correction at frame t propagates forward through the
    kinematic/odometry chain, one frame per Jacobi round — a pure global
    fixed-point iteration diverges; measured), but it CAN be batched at
    chunk granularity:

    * the trajectory is processed in chunks of ``init_chunk_len`` frames;
      the lax.scan runs over ~T/C chunks instead of T frames, carrying the
      landmark table (weighted sums + counts + live count) and the last
      pose — causality across chunks is exact;
    * within a chunk, Picard rounds run fully batched until the chunk
      settles (``PICARD_TOL``), at most C of them:
      predictions from the previous round's poses, causal association of
      all C frames at once (exclusive cumulative segment-sums over the
      carried table + the chunk's own labels reproduce the reference's
      running means; a column is visible iff its exclusive count is
      positive, and the one-new-label-per-frame quirk is a cumsum of frame
      flags, as in the batched refine sweep), matched values from the
      INCLUSIVE running means, then all C one-sided LM solves in one vmap
      and an exact dead-reckon fill of empty-frame gaps via parallel
      cumulative sums.

    The chain is causal, so round k fixes frame k: C rounds reproduce the
    sequential init.  A fixed round count below C is not enough where new
    landmarks start often: on the seeded reference-shape world, 2 rounds
    of C=32 left the sequential init by a mean 0.34 m.  The early stop
    keeps the common chunk to a few rounds.

    Requires the default unicycle kinematics (the dead-reckon fill encodes
    them) and the replicate_new_obs quirk; ``_init_jit`` falls back to the
    sequential scan otherwise.
    """
    cap = config.obs_cap or 0
    if cap and cap < data.dist.shape[1]:
        data = compact_data(data, cap)
    elif data.ang.ndim == 1:
        data = data._replace(ang=jnp.broadcast_to(data.ang, data.dist.shape))

    T, B = data.dist.shape
    L = seed.pos.shape[0]
    dtype = x0.dtype
    dist_thr = config.dist_thr
    model = _model_of(config)
    deltat = config.deltat
    C = max(2, int(config.init_chunk_len))
    jac1, _ = _jacs_of(config)
    z3 = jnp.zeros((3,), dtype)
    z2 = jnp.zeros((2,), dtype)

    # frames 1..T-1 (frame 0 is the seed), padded to a multiple of C with
    # all-masked (empty) frames that dead-reckon and touch nothing
    n = T - 1
    nc = -(-n // C)
    pad = nc * C - n

    def pad_c(a):
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    dist = pad_c(data.dist[1:]).reshape(nc, C, B)
    mask = pad_c(data.mask[1:]).reshape(nc, C, B)
    ang = pad_c(data.ang[1:]).reshape(nc, C, B)
    odom = pad_c(data.odom[1:]).reshape(nc, C, 3)
    # per-frame PREVIOUS control / odometry (avoids cross-chunk indexing)
    u_prev = pad_c(data.u[0:T - 1]).reshape(nc, C, 2)
    odom_prev = pad_c(data.odom[0:T - 1]).reshape(nc, C, 3)

    if 0 < C * B * (L + 1) <= config.assoc_onehot_max_elems:
        # one-hot matmul per chunk: the init is latency-bound (a ~T/C-step
        # sequential scan of small ops), so collapsing 3 vmapped scatter
        # segment-sums into one contraction shortens each round's
        # dependency chain; HIGHEST keeps f32 coordinates exact (a
        # reduced-precision matmul would round them to bf16 or TF32)
        def batched_frame_sums(px, py, l, wi):
            lc = jnp.minimum(l, L)
            oh = (lc[..., None] == jnp.arange(L + 1)).astype(dtype)
            vals = jnp.stack([px * wi, py * wi, wi], axis=-1)   # (C, B, 3)
            s = jnp.einsum('cbl,cbv->cvl', oh, vals,
                           precision=jax.lax.Precision.HIGHEST)
            return s[:, 0, :L], s[:, 1, :L], s[:, 2, :L]
    else:
        def frame_sums(px, py, l, wi):
            lc = jnp.minimum(l, L)
            sx = jax.ops.segment_sum(px * wi, lc, num_segments=L + 1)[:L]
            sy = jax.ops.segment_sum(py * wi, lc, num_segments=L + 1)[:L]
            c = jax.ops.segment_sum(wi, lc, num_segments=L + 1)[:L]
            return sx, sy, c

        batched_frame_sums = jax.vmap(frame_sums)

    def chunk_body(carry, inp):
        base_sx, base_sy, base_cnt, nact, x_last = carry
        dist_c, mask_c, ang_c, odom_c, u_prev_c, odom_prev_c = inp
        empty = ~jnp.any(mask_c, axis=1)                    # (C,)

        def rechain(xs, x_prev_stale, keep_abs=None):
            """Re-compose the pose chain from the carried anchor.

            Frames flagged ``keep_abs`` keep their absolutely-anchored
            solved pose and re-anchor the chain; the rest (empty frames /
            round-0 dead-reckoning) contribute their pose RELATIVE to the
            stale predecessor, composed downstream in one parallel
            (segmented) SE(2) associative scan.  A full relative rechain
            (no keep_abs) was measured divergent from a cold start —
            composing per-frame relative corrections amplifies early-round
            association noise along the chain.
            """
            dth = xs[:, 2] - x_prev_stale[:, 2]
            d = xs[:, :2] - x_prev_stale[:, :2]
            c = jnp.cos(x_prev_stale[:, 2])
            sn = jnp.sin(x_prev_stale[:, 2])
            rx = c * d[:, 0] + sn * d[:, 1]          # rel in prev frame
            ry = -sn * d[:, 0] + c * d[:, 1]

            th = jnp.concatenate([x_last[2:3], dth])
            px = jnp.concatenate([x_last[0:1], rx])
            py = jnp.concatenate([x_last[1:2], ry])
            if keep_abs is None:
                anc = jnp.zeros((C + 1,), bool).at[0].set(True)
            else:
                anc = jnp.concatenate(
                    [jnp.ones((1,), bool), keep_abs])
            # segmented compose: an anchored element resets the prefix
            th = jnp.where(anc, jnp.concatenate([x_last[2:3], xs[:, 2]]), th)
            px = jnp.where(anc, jnp.concatenate([x_last[0:1], xs[:, 0]]), px)
            py = jnp.where(anc, jnp.concatenate([x_last[1:2], xs[:, 1]]), py)

            def compose(a, b):
                tha, txa, tya, aa = a
                thb, txb, tyb, ab = b
                ca, sa = jnp.cos(tha), jnp.sin(tha)
                th_ = jnp.where(ab, thb, tha + thb)
                tx_ = jnp.where(ab, txb, txa + ca * txb - sa * tyb)
                ty_ = jnp.where(ab, tyb, tya + sa * txb + ca * tyb)
                return (th_, tx_, ty_, aa | ab)

            th, px, py, _ = jax.lax.associative_scan(
                compose, (th, px, py, anc))
            return jnp.stack([px, py, th], axis=-1)[1:]

        def assoc_pass(pts, pts_prev, lab_prev):
            """One association round + anchored matched targets.

            All cross-frame running-mean mass comes from the PREVIOUS
            round's self-consistent (points, labels) snapshot; only each
            frame's OWN current observations are folded in on top (the
            reference reads the table inclusively after its own update,
            ICM_SLAM.py:184-194).  Anchoring the cross-frame mass is what
            makes the Picard iteration stable: rebuilding the means from
            the CURRENT points each round lets the map drift along with
            the poses (nothing anchors the gauge — measured divergence
            after a few rounds), while the anchored variant has the same
            fixed point (at convergence the snapshots coincide).
            """
            wgt = (lab_prev < L).astype(dtype)
            sx, sy, cnt = batched_frame_sums(pts_prev[..., 0],
                                             pts_prev[..., 1],
                                             lab_prev, wgt)
            # EXCLUSIVE prefix: the table as each frame sees it
            csx = base_sx[None] + jnp.cumsum(sx, 0) - sx     # (C, L)
            csy = base_sy[None] + jnp.cumsum(sy, 0) - sy
            ccn = base_cnt[None] + jnp.cumsum(cnt, 0) - cnt
            ex = csx / jnp.maximum(ccn, 1.0)
            ey = csy / jnp.maximum(ccn, 1.0)
            live = ccn > 0
            dx = pts[..., 0:1] - ex[:, None, :]
            dy = pts[..., 1:2] - ey[:, None, :]
            d2 = jnp.where(live[:, None, :], dx * dx + dy * dy, jnp.inf)
            lab = jnp.argmin(d2, axis=2).astype(jnp.int32)
            min2 = jnp.take_along_axis(d2, lab[..., None], 2)[..., 0]
            far = (min2 > dist_thr * dist_thr) & mask_c
            lab = jnp.where(mask_c, lab, L)
            # quirk (ICM_SLAM.py:176): one shared new label per far frame
            has_far = jnp.any(far, axis=1)
            new_id = nact + jnp.cumsum(has_far).astype(jnp.int32) - 1
            lab = jnp.where(far, jnp.minimum(new_id[:, None], L), lab)
            n_new = jnp.sum(has_far).astype(jnp.int32)

            # matched = anchored exclusive mass + own current contribution
            wgt_c = (lab < L).astype(dtype)
            osx, osy, ocn = batched_frame_sums(pts[..., 0], pts[..., 1],
                                               lab, wgt_c)
            rx = (csx + osx) / jnp.maximum(ccn + ocn, 1.0)
            ry = (csy + osy) / jnp.maximum(ccn + ocn, 1.0)
            lab_cl = jnp.clip(lab, 0, L - 1)
            mx = jnp.take_along_axis(rx, lab_cl, axis=1)
            my = jnp.take_along_axis(ry, lab_cl, axis=1)
            matched = jnp.stack([mx, my], axis=-1)
            # far beams match the NEW landmark = the mean of their own
            # frame's far cluster (ICM_SLAM.py:176/184-194) — OWN-frame
            # mass only, never table mass: the new-label column may hold a
            # DIFFERENT landmark's mass from the previous round's
            # numbering.  (One shared cluster in the quirk round;
            # per-component clusters in the spatial rounds.)
            ox = jnp.take_along_axis(osx, lab_cl, axis=1)
            oy = jnp.take_along_axis(osy, lab_cl, axis=1)
            oc = jnp.maximum(jnp.take_along_axis(ocn, lab_cl, axis=1), 1.0)
            matched = jnp.where(far[..., None],
                                jnp.stack([ox / oc, oy / oc], axis=-1),
                                matched)
            # chunk-total mass of the CURRENT snapshot (carried forward)
            fx = base_sx + jnp.sum(osx, axis=0)
            fy = base_sy + jnp.sum(osy, axis=0)
            fc = base_cnt + jnp.sum(ocn, axis=0)
            return lab, n_new, matched, fx, fy, fc

        def solve_round(x_prev_arr, xp, matched):
            def solve(i):
                prob = PoseProblem(
                    dist=dist_c[i], ang=ang_c[i], mask=mask_c[i],
                    matched=matched[i], x_prev=x_prev_arr[i],
                    u_prev=u_prev_c[i], odo_prev=odom_prev_c[i],
                    odo_cur=odom_c[i], x_next=z3, u_cur=z2, odo_next=z3)
                return lm_minimize(
                    lambda xx: one_sided_residuals(xx, prob, w, model),
                    xp[i], iters=config.init_gn_iters or
                    config.pose_gn_iters,
                    jac_fn=None if jac1 is None else
                    (lambda xx: jac1(xx, prob, w)))

            xs = jax.vmap(solve)(jnp.arange(C))
            # empty frames take the pure kinematic increment, so the
            # rechain dead-reckons them exactly (ICM_ROS.py:104-106).
            # Solved frames keep their ABSOLUTE pose (rechain measured
            # divergent from a cold start: relative-pose composition
            # amplifies early-round map noise across the chain).
            xs = jnp.where(empty[:, None], xp, xs)
            return rechain(xs, x_prev_arr, keep_abs=~empty)

        # round 0: chain the measured ODOMETRY increments from the carried
        # pose (closer to the init fixed point than the control-model
        # chain: the reference's per-pose cost pulls each increment toward
        # the odometry residual, ICM_ROS.py:272-277 — so round-0
        # association drift over the chunk is smaller; measured)
        dth0 = odom_c[:, 2] - odom_prev_c[:, 2]
        dw0 = odom_c[:, :2] - odom_prev_c[:, :2]
        c0 = jnp.cos(odom_prev_c[:, 2])
        s0 = jnp.sin(odom_prev_c[:, 2])
        rel0 = jnp.stack([c0 * dw0[:, 0] + s0 * dw0[:, 1],
                          -s0 * dw0[:, 0] + c0 * dw0[:, 1]], axis=-1)
        # feed rechain poses whose relative transform IS the odometry
        # increment: stale prev = identity-at-origin, pose = (rel, dth)
        x0p = jnp.zeros((C, 3), dtype)
        x = rechain(jnp.concatenate([rel0, dth0[:, None]], axis=1), x0p)

        def picard_round(st):
            r, x, pts_prev, lab, dx_last, _, n_new, fx, fy, fc = st
            x_prev_arr = jnp.concatenate([x_last[None], x[:-1]], 0)
            xp = model.kinematics(x_prev_arr, u_prev_c, deltat)
            pts = beams_to_world(xp, dist_c, ang_c)
            lab_new, n_new, matched, fx, fy, fc = assoc_pass(
                pts, pts_prev, lab)
            x_new = solve_round(x_prev_arr, xp, matched)
            dx = jnp.max(jnp.abs(x_new - x))
            # the round's whole input (poses, the previous round's points
            # and labels) repeats: the fixed point, which the causal
            # chain makes unique and equal to the sequential init's
            settled = (jnp.all(lab_new == lab)
                       & (jnp.maximum(dx, dx_last) <= PICARD_TOL))
            return (r + 1, x_new, pts, lab_new, dx, settled, n_new,
                    fx, fy, fc)

        # round k settles frame k of the chunk, so C rounds reproduce the
        # sequential init; most chunks reach the fixed point sooner
        zl = jnp.zeros((L,), dtype)
        st = (jnp.int32(0), x, jnp.zeros((C, B, 2), dtype),
              jnp.full((C, B), L, jnp.int32), jnp.asarray(jnp.inf, dtype),
              jnp.asarray(False), jnp.int32(0), zl, zl, zl)
        _, x, pts_prev, lab, _, _, n_new, fx, fy, fc = jax.lax.while_loop(
            lambda s: (s[0] < C) & ~s[5], picard_round, st)

        if config.init_final_assoc:
            # final map-build with the CONVERGED poses (no solves): the
            # quirk new-label rule applies here, so the committed table
            # carries the reference's label structure computed from settled
            # predictions — transient junk from the Picard rounds holds no
            # mass
            x_prev_arr = jnp.concatenate([x_last[None], x[:-1]], 0)
            xp = model.kinematics(x_prev_arr, u_prev_c, deltat)
            pts = beams_to_world(xp, dist_c, ang_c)
            lab, n_new, _, fx, fy, fc = assoc_pass(pts, pts_prev, lab)
        # else: commit the LAST Picard round's masses (computed at that
        # round's pre-solve predictions) — one association pass less of
        # sequential depth per chunk (init_final_assoc=False, opt-in)

        carry = (fx, fy, fc, nact + n_new, x[-1])
        return carry, x

    base_sx = seed.pos[:, 0] * seed.counts
    base_sy = seed.pos[:, 1] * seed.counts
    carry0 = (base_sx, base_sy, seed.counts, seed.nact, x0)
    (fsx, fsy, fcnt, nact, _), xs = jax.lax.scan(
        chunk_body, carry0,
        (dist, mask, ang, odom, u_prev, odom_prev))
    x = jnp.concatenate([x0[None], xs.reshape(nc * C, 3)[:n]], axis=0)
    live = fcnt > 0
    pos = jnp.stack([fsx, fsy], axis=-1) \
        / jnp.maximum(fcnt, 1.0)[:, None] * live[:, None]
    # merge duplicate columns (count-weighted), WITHOUT pruning: chunk
    # round-0 blindness can split one physical landmark's observations
    # across near-coincident columns; the reference's filtrar merge
    # (ICM_SLAM.py:224-258) then sees each shard below cota and would drop
    # the landmark entirely.  Merging first reconstructs the sequential
    # table structure (cota pruning still happens in the normal filter
    # step that follows the init).
    # the merge (cota=0) sees ALL allocated labels, so a cap-sliced merge
    # is exact iff raw_nact <= cap — runtime-witnessed: run() errors on
    # violation (unlike the refine filter, whose keep mask prunes to the
    # provable cota bound before compaction).  Cuts the K-step relabel
    # walk + KxK matrix from L=1024 to the cap width.
    from icm_slam_tpu.mapping.landmark_map import filter_map as _merge
    merged = _merge(MapState(pos, fcnt, nact), 0.0, dist_thr,
                    live_cap=resolve_init_merge_cap(config))
    # the merge compacts nact to <= L, which would mask a table overflow —
    # return the RAW allocated-label count so run()'s check_table_overflow
    # can actually fire on this (default) init path
    return merged, x, nact


# ---------------------------------------------------------------------------
# sequential refinement sweep (fidelity mode)
# ---------------------------------------------------------------------------

def refine_sweep_sequential(data: SweepData, old_map: MapState, x, config, w
                            ) -> Tuple[MapState, jnp.ndarray]:
    """One Gauss-Seidel ICM sweep, faithful to ICM_ROS.py:121-164."""
    T = x.shape[0]
    L = old_map.pos.shape[0]
    dist_thr = config.dist_thr
    quirk = config.replicate_new_obs_quirk
    model = _model_of(config)
    jac1, jac2 = _jacs_of(config)
    dtype = x.dtype

    state0 = MapState(jnp.zeros((L, 2), dtype), jnp.zeros((L,), dtype),
                      old_map.nact)
    x0 = x[0]
    pts0 = beams_to_world(x0, data.dist[0], data.ang)
    state0, _ = update(state0, old_map.pos, old_map.nact, pts0, data.mask[0],
                       dist_thr, quirk)

    def _assoc_frame(state, x_all, t):
        """Map update at frame t using its stale pose; returns matched."""
        pts = beams_to_world(x_all[t], data.dist[t], data.ang)
        new_state, labels = update(state, old_map.pos, old_map.nact, pts,
                                   data.mask[t], dist_thr, quirk)
        matched = new_state.pos[jnp.clip(labels, 0, L - 1)]
        return new_state, matched

    def step(carry, t):
        state, x_all, xt_run = carry
        empty = ~jnp.any(data.mask[t])

        new_state, matched = _assoc_frame(state, x_all, t)
        x_prev = x_all[t - 1]                       # fresh (already updated)
        x_next = x_all[t + 1]                       # stale

        # interior pose: symmetric two-sided cost, init at midpoint
        prob2 = PoseProblem(
            dist=data.dist[t], ang=data.ang, mask=data.mask[t],
            matched=matched, x_prev=x_prev, u_prev=data.u[t - 1],
            odo_prev=data.odom[t - 1], odo_cur=data.odom[t], x_next=x_next,
            u_cur=data.u[t], odo_next=data.odom[t + 1])
        x_opt = lm_minimize(
            lambda xx: two_sided_residuals(xx, prob2, w, model),
            (x_prev + x_next) / 2.0, iters=config.pose_gn_iters,
            jac_fn=None if jac2 is None else
            (lambda xx: jac2(xx, prob2, w)), closed_form=False)

        x_avg = (xt_run + x_next) / 2.0            # empty-frame path
        x_t = jnp.where(empty, x_avg, x_opt)
        state = jax.tree.map(lambda a, b: jnp.where(empty, a, b), state,
                             new_state)
        x_all = x_all.at[t].set(x_t)
        return (state, x_all, x_t), None

    # interior frames 1..T-2 in the sequential scan
    (state, x_all, xt_run), _ = jax.lax.scan(step, (state0, x, x[0]),
                                             jnp.arange(1, T - 1))

    # final frame: one-sided cost (ICM_ROS.py:153-156), outside the scan so
    # the scan body carries only the two-sided solver
    t = T - 1
    empty_last = ~jnp.any(data.mask[t])
    new_state, matched = _assoc_frame(state, x_all, t)
    x_prev = x_all[t - 1]
    prob1 = _problem_one_sided(data, t, matched, x_prev)
    x_one = lm_minimize(
        lambda xx: one_sided_residuals(xx, prob1, w, model),
        model.kinematics(x_prev, data.u[t - 1], config.deltat),
        iters=config.pose_gn_iters,
        jac_fn=None if jac1 is None else (lambda xx: jac1(xx, prob1, w)),
        closed_form=False)
    # reference quirk: an empty LAST frame would index x[:, t+1] and crash
    # (ICM_ROS.py:144); we dead-reckon from the running pose instead
    x_t = jnp.where(empty_last, (xt_run + x_all[t]) / 2.0, x_one)
    state = jax.tree.map(lambda a, b: jnp.where(empty_last, a, b), state,
                         new_state)
    x_all = x_all.at[t].set(x_t)

    # reference early return (ICM_ROS.py:133-135): an EMPTY frame 0 aborts
    # the whole sweep and returns (mapa_viejo, x) untouched
    empty0 = ~jnp.any(data.mask[0])
    state = jax.tree.map(lambda a, b: jnp.where(empty0, a, b), old_map, state)
    x_all = jnp.where(empty0, x, x_all)
    return state, x_all


# ---------------------------------------------------------------------------
# batched refinement sweep (parallel mode)
# ---------------------------------------------------------------------------

def batched_associate(data: SweepData, old_map: MapState, x, config):
    """Associate every frame against the frozen map in one batched pass.

    Returns (labels (T,B) int32 in [0, L] with L = discard,
             map_after (MapState), matched (T,B,2) running-mean values).

    The distance search only scans the first ``map_run_cap`` reference
    columns when that cap is active: run() guarantees the frozen map's live
    count stays below it (live landmarks <= total_obs / cota), so the
    remaining L - cap columns are provably dead and can't win the argmin.
    """
    T, B = data.dist.shape
    L = old_map.pos.shape[0]
    dist_thr = config.dist_thr
    dtype = x.dtype

    Lr = L
    if config.map_run_cap and config.map_run_cap < L:
        Lr = config.map_run_cap
    ref_pos = old_map.pos[:Lr]

    pts = beams_to_world(x, data.dist, data.ang)            # (T, B, 2)

    ref_live = jnp.arange(Lr) < old_map.nact
    lab, _ = jax.vmap(
        lambda p, m: associate(ref_pos, ref_live, p, m, dist_thr)
    )(pts, data.mask)                                        # (T, B)
    if Lr < L:
        # associate() marks masked-out beams with its own column count;
        # restore the full-table discard sentinel
        lab = jnp.where(lab == Lr, L, lab)

    far = lab == -1
    if config.replicate_new_obs_quirk:
        has_far = jnp.any(far, axis=1)                       # (T,)
        # frame t's new label = nact0 + (#frames before t that spawned one)
        new_id = old_map.nact + jnp.cumsum(has_far) - 1
        lab = jnp.where(far, new_id[:, None], lab)
        n_new = jnp.sum(has_far).astype(jnp.int32)

        cap_l = config.map_run_cap
        if cap_l and cap_l < L:
            # Fast running-mean path. A NEW landmark only ever receives
            # observations from its creating frame (association runs against
            # the frozen old map; one new label per frame), so its running
            # mean IS the frame's far-obs mean — no (T, L) machinery needed.
            # Old labels are < nact0, which run() guarantees to be < cap_l
            # (bound: live landmarks <= total_obs / cota).
            w = (lab < L).astype(dtype)
            far_w = (far & data.mask).astype(dtype)          # (T, B)
            fcnt = jnp.sum(far_w, axis=1)                    # (T,)
            fmean = jnp.stack(
                [jnp.sum(pts[..., 0] * far_w, axis=1),
                 jnp.sum(pts[..., 1] * far_w, axis=1)], axis=-1) \
                / jnp.maximum(fcnt, 1.0)[:, None]            # (T, 2)

            lab_old = jnp.where(far | (lab >= cap_l), cap_l, lab)

            if T * B * (cap_l + 1) <= config.assoc_onehot_max_elems:
                # one-hot matmul instead of 3 vmapped scatter segment-sums:
                # one fused batched contraction, where scatter-add
                # serializes duplicate indices.  Size-gated: the
                # materialized (T, B, cap+1) one-hot is too large at the
                # 20k-frame stress scale, where the chunked path below
                # takes over.
                oh = (lab_old[..., None] ==
                      jnp.arange(cap_l + 1)).astype(dtype)   # (T, B, cap+1)
                vals = jnp.stack([pts[..., 0] * w, pts[..., 1] * w, w],
                                 axis=-1)                    # (T, B, 3)
                # HIGHEST: a reduced-precision matmul (bf16 or TF32 inputs)
                # would quantize landmark coordinates to ~3 digits; with
                # exact 0/1 one-hots full f32 keeps each product exact
                sums = jnp.einsum('tbc,tbv->tvc', oh, vals,
                                  precision=jax.lax.Precision.HIGHEST)
                sums = sums[:, :, :cap_l]                    # (T, 3, cap_l)
            else:
                # CHUNKED one-hot einsum: past the one-shot gate (e.g. the
                # 20k-frame stress world) the materialized (T, B, cap+1)
                # one-hot is too large, but each frame's sums only need its
                # OWN chunk — so a lax.map over ceil(T/Tc) chunks keeps the
                # matmul contraction (exact: every frame lies entirely
                # inside one chunk, so per-frame sums are bitwise-identical
                # to the one-shot einsum) while materializing one chunk's
                # one-hot at a time under the same element budget.
                Tc = max(1, config.assoc_onehot_max_elems
                         // (B * (cap_l + 1)))
                Tc = min(Tc, T)
                nch = -(-T // Tc)
                padT = nch * Tc - T

                def pad_t(a):
                    return jnp.pad(a, [(0, padT)] + [(0, 0)] * (a.ndim - 1))

                # padded rows: w = 0 -> zero contribution everywhere
                vals_f = jnp.stack([pts[..., 0] * w, pts[..., 1] * w, w],
                                   axis=-1)                  # (T, B, 3)
                lab_ch = pad_t(lab_old).reshape(nch, Tc, B)
                vals_ch = pad_t(vals_f).reshape(nch, Tc, B, 3)

                def chunk_sums(args):
                    l_c, v_c = args
                    oh = (l_c[..., None] ==
                          jnp.arange(cap_l + 1)).astype(dtype)
                    s = jnp.einsum('tbc,tbv->tvc', oh, v_c,
                                   precision=jax.lax.Precision.HIGHEST)
                    return s[:, :, :cap_l]                   # (Tc, 3, cap_l)

                sums = jax.lax.map(chunk_sums, (lab_ch, vals_ch))
                sums = sums.reshape(nch * Tc, 3, cap_l)[:T]  # (T, 3, cap_l)
            # one fused (T, 3, cap) prefix sum instead of three (T, cap)
            # ones — the running means are per-plane prefix sums either
            # way (bitwise-identical), this just cuts op count in the
            # latency-bound sweep body.
            cums = jnp.cumsum(sums, axis=0)                  # (T, 3, cap_l)
            cum_cnt = cums[:, 2]
            denom = jnp.maximum(cum_cnt, 1.0)
            run_x = cums[:, 0] / denom
            run_y = cums[:, 1] / denom

            lab_c = jnp.clip(lab, 0, cap_l - 1)
            mx = jnp.take_along_axis(run_x, lab_c, axis=1)
            my = jnp.take_along_axis(run_y, lab_c, axis=1)
            matched = jnp.stack([mx, my], axis=-1)           # (T, B, 2)
            matched = jnp.where(far[..., None],
                                fmean[:, None, :], matched)

            # final table: old columns from the cumulative sums, new
            # columns scattered from the per-frame far means
            live_last = cum_cnt[-1] > 0
            pos = jnp.zeros((L, 2), dtype)
            pos = pos.at[:cap_l].set(
                jnp.stack([run_x[-1], run_y[-1]], axis=-1)
                * live_last[:, None])
            counts_f = jnp.zeros((L,), dtype).at[:cap_l].set(cum_cnt[-1])
            scatter_id = jnp.where(has_far, new_id, L)
            pos = pos.at[jnp.clip(scatter_id, 0, L)].set(
                fmean, mode="drop")
            counts_f = counts_f.at[jnp.clip(scatter_id, 0, L)].set(
                fcnt, mode="drop")
            final = MapState(pos, counts_f, old_map.nact + n_new)
            return lab, final, matched
    else:
        from icm_slam_tpu.mapping.landmark_map import (
            compact_labels, connected_component_labels)

        def frame_components(p, m, f):
            comp = connected_component_labels(p, f & m, dist_thr)
            comp = compact_labels(comp, f & m, B)
            k = jnp.where(jnp.any(f & m),
                          jnp.max(jnp.where(f & m, comp, -1)) + 1, 0)
            return comp, k

        comp, k = jax.vmap(frame_components)(pts, data.mask, far)
        base = old_map.nact + jnp.cumsum(k) - k
        lab = jnp.where(far, base[:, None] + comp, lab)
        n_new = jnp.sum(k).astype(jnp.int32)

    # --- running-mean map via cumulative segment sums -----------------------
    w = (lab < L).astype(dtype)                               # (T, B)

    # per-frame segment sums as SEPARATE x/y (T, L) planes, not one
    # (T, L, 2) array with a trailing size-2 axis
    def frame_sums(px, py, l, wi):
        sx = jax.ops.segment_sum(px * wi, l, num_segments=L + 1)[:L]
        sy = jax.ops.segment_sum(py * wi, l, num_segments=L + 1)[:L]
        c = jax.ops.segment_sum(wi, l, num_segments=L + 1)[:L]
        return sx, sy, c

    sx, sy, cnts = jax.vmap(frame_sums)(pts[..., 0], pts[..., 1], lab, w)
    cum_cnt = jnp.cumsum(cnts, axis=0)                        # (T, L)
    denom = jnp.maximum(cum_cnt, 1.0)
    run_x = jnp.cumsum(sx, axis=0) / denom
    run_y = jnp.cumsum(sy, axis=0) / denom

    lab_c = jnp.clip(lab, 0, L - 1)
    mx = jnp.take_along_axis(run_x, lab_c, axis=1)            # (T, B)
    my = jnp.take_along_axis(run_y, lab_c, axis=1)
    matched = jnp.stack([mx, my], axis=-1)                    # (T, B, 2)

    live_last = cum_cnt[-1] > 0
    final_pos = jnp.stack([run_x[-1], run_y[-1]], axis=-1) * live_last[:, None]
    final = MapState(final_pos, cum_cnt[-1], old_map.nact + n_new)
    return lab, final, matched


def compact_data(data: SweepData, cap: int) -> SweepData:
    """Compact each frame's valid beams to the front BEFORE association.

    The compaction order depends only on the (static) validity mask, so
    running association on the compacted beams is exact when ``cap`` >= the
    dataset's max per-frame valid count (auto_obs_cap): dropped beams are all
    masked-out, i.e. they would get the discard label and zero weight in
    every downstream sum.  Cuts the (T, B, L) distance search and the
    per-frame segment sums from B=181 beams to ~cap=24.
    The returned ``ang`` is per-frame (T, cap); beams_to_world broadcasts.
    """
    order = jnp.argsort(~data.mask, axis=1, stable=True)[:, :cap]   # (T,cap)
    return SweepData(
        dist=jnp.take_along_axis(data.dist, order, axis=1),
        mask=jnp.take_along_axis(data.mask, order, axis=1),
        ang=data.ang[order],
        odom=data.odom, u=data.u)


def compact_obs(data: SweepData, matched, cap: int):
    """Gather each frame's valid beams to the front and truncate to ``cap``.

    Real frames carry only ~10-17 informative beams out of 181 (the scan
    filter removes the rest); pose solves over the full padded beam axis
    waste ~90% of their FLOPs on zero residuals.  ``cap`` must be >= the
    dataset's max per-frame valid count for exactness (auto_obs_cap).
    Returns (dist (T,cap), ang (T,cap), mask (T,cap), matched (T,cap,2)).
    """
    order = jnp.argsort(~data.mask, axis=1, stable=True)[:, :cap]   # (T,cap)
    dist_c = jnp.take_along_axis(data.dist, order, axis=1)
    ang_c = data.ang[order]
    mask_c = jnp.take_along_axis(data.mask, order, axis=1)
    matched_c = jnp.take_along_axis(matched, order[..., None], axis=1)
    return dist_c, ang_c, mask_c, matched_c


def auto_obs_cap(mask, multiple: int = 8) -> int:
    """Smallest safe compaction budget for a dataset (host-side, static)."""
    import numpy as np
    m = int(np.asarray(mask.sum(axis=1)).max()) if mask.shape[0] else 0
    return max(multiple, -(-m // multiple) * multiple)


def _solve_two_at(data: SweepData, x, obs, config, w, ts, last_t=None):
    """Two-sided LM solves for the pose subset ``ts`` (K,) — one vmapped
    batch of K problems, not T (half-pass only updates one parity).
    ``obs`` = (dist, ang, mask, matched), each (T, cap...)-shaped.

    ``last_t`` (static, optional): the trajectory's last real frame is
    solved with the ONE-SIDED cost (ICM_ROS.py:153-156) FOLDED into the
    same vmapped batch.  The default two-sided residual vector stacks
    [r_kinf(3), r_odof(3), one_sided...] (core.energy.two_sided_residuals),
    so zeroing the 6 forward rows yields exactly the one-sided system —
    zero rows contribute exact zeros to J^T J / J^T r / the cost — and the
    init switches to the kinematic prediction (ICM_ROS.py:254-260).  This
    removes the separate batch-of-1 LM chain the caller previously ran
    after the batch: one whole sequential LM-scan latency per matching
    half-pass, a pure step-count cut in the latency-bound sweep body.
    Callers must gate on the default [forward, backward] stacking
    (model.two_sided / extra_two_sided unset, no analytic two-sided jac).
    """
    T = x.shape[0]
    model = _model_of(config)
    _, jac2 = _jacs_of(config)
    dist_c, ang_c, mask_c, matched_c = obs

    def solve(t):
        tm1 = jnp.maximum(t - 1, 0)
        tp1 = jnp.minimum(t + 1, T - 1)
        prob = PoseProblem(
            dist=dist_c[t], ang=ang_c[t], mask=mask_c[t],
            matched=matched_c[t], x_prev=x[tm1], u_prev=data.u[tm1],
            odo_prev=data.odom[tm1], odo_cur=data.odom[t],
            x_next=x[tp1], u_cur=data.u[t], odo_next=data.odom[tp1])
        x_init = (x[tm1] + x[tp1]) / 2.0
        if last_t is None:
            def resid(xx):
                return two_sided_residuals(xx, prob, w, model)
        else:
            is_last = t == last_t
            x_init = jnp.where(
                is_last,
                model.kinematics(x[tm1], data.u[tm1], config.deltat),
                x_init)

            def resid(xx):
                r = two_sided_residuals(xx, prob, w, model)
                head = jnp.arange(r.shape[0]) < 6
                return jnp.where(is_last & head, 0.0, r)
        return lm_minimize(
            resid, x_init, iters=config.pose_gn_iters,
            jac_fn=None if jac2 is None else
            (lambda xx: jac2(xx, prob, w)))

    return jax.vmap(solve)(ts)


def _solve_one_at(data: SweepData, x, obs, config, w, t):
    """One-sided LM solve at frame ``t`` (the trajectory's last frame)."""
    model = _model_of(config)
    jac1, _ = _jacs_of(config)
    dist_c, ang_c, mask_c, matched_c = obs
    tm1 = jnp.maximum(t - 1, 0)
    z3 = jnp.zeros((3,), x.dtype)
    prob = PoseProblem(
        dist=dist_c[t], ang=ang_c[t], mask=mask_c[t], matched=matched_c[t],
        x_prev=x[tm1], u_prev=data.u[tm1], odo_prev=data.odom[tm1],
        odo_cur=data.odom[t], x_next=z3, u_cur=jnp.zeros((2,), x.dtype),
        odo_next=z3)
    x_init = model.kinematics(x[tm1], data.u[tm1], config.deltat)
    return lm_minimize(
        lambda xx: one_sided_residuals(xx, prob, w, model),
        x_init, iters=config.pose_gn_iters,
        jac_fn=None if jac1 is None else (lambda xx: jac1(xx, prob, w)))


def refine_sweep_batched(data: SweepData, old_map: MapState, x, config, w,
                         last_t: int | None = None
                         ) -> Tuple[MapState, jnp.ndarray]:
    """One parallel ICM sweep: batched association + red-black poses.

    ``last_t``: index of the last REAL frame (defaults to T-1).  When the
    time axis is padded up to the mesh size, frames past last_t are
    all-masked and excluded from pose selection.
    """
    T = x.shape[0]
    if last_t is None:
        last_t = T - 1
    empty = ~jnp.any(data.mask, axis=1)                       # (T,)

    # compact beams BEFORE association: the whole sweep — distance search,
    # running-mean sums, pose solves — then runs on ~cap beams, not B=181
    cap = config.obs_cap if config.obs_cap else data.dist.shape[1]
    if cap < data.dist.shape[1]:
        data_c = compact_data(data, cap)
    else:
        data_c = data._replace(ang=jnp.broadcast_to(data.ang,
                                                    data.dist.shape))
    # named scopes label the sweep's layers in profiler traces
    with jax.named_scope("association"):
        _, final_map, matched = batched_associate(data_c, old_map, x, config)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)

    # fold the last frame's one-sided solve into the vmapped batch when the
    # energy keeps the default [forward(6), backward] residual stacking —
    # otherwise fall back to the separate batch-of-1 LM chain
    model = _model_of(config)
    _, jac2 = _jacs_of(config)
    fold_last = (model.two_sided is None and model.extra_two_sided is None
                 and jac2 is None)

    def solve_at(x, ts, parity=None):
        """Solve the poses ``ts`` against the CURRENT x (two-sided; the
        last real frame one-sided, ICM_ROS.py:153-156), with the empty-
        frame neighbour average and padded-frame freeze."""
        cand = _solve_two_at(data, x, obs, config, w, ts,
                             last_t=last_t if fold_last else None)
        if fold_last:
            pass  # the one-sided solve rode the batch (see _solve_two_at)
        elif parity is None:
            if int(last_t) >= 1:
                cand = cand.at[int(last_t) - 1].set(
                    _solve_one_at(data, x, obs, config, w, last_t))
        else:
            start = 1 if parity == 1 else 2
            if int(last_t) % 2 == parity and int(last_t) >= start:
                pos = (int(last_t) - start) // 2
                cand = cand.at[pos].set(
                    _solve_one_at(data, x, obs, config, w, last_t))
        tm1 = jnp.maximum(ts - 1, 0)
        # clamp the forward neighbour to the last REAL frame: on a padded
        # time axis x[last_t + 1] is a zero pose and would pull an empty
        # frame's average halfway toward the origin
        tp1 = jnp.minimum(ts + 1, last_t)
        x_avg = (x[tm1] + x[tp1]) / 2.0
        cand = jnp.where(empty[ts][:, None], x_avg, cand)
        keep = (ts <= last_t)[:, None]
        cand = jnp.where(keep, cand, x[ts])
        return x.at[ts].set(cand)

    with jax.named_scope("pose_solve"):
        if config.pose_update == "jacobi":
            # one full Jacobi pass per pose_pass: every pose solved against
            # the PREVIOUS pass's neighbours — half the sequential LM depth
            # of a red-black pair, but each step solves all T poses where a
            # half-pass solves T/2.  An opt-in fixed-point variant, not a
            # speed knob; its speed on the GPU is not measured.
            for _ in range(config.pose_passes):
                x = solve_at(x, jnp.arange(1, T))
        else:
            for _ in range(config.pose_passes):
                x = solve_at(x, jnp.arange(1, T, 2), parity=1)
                x = solve_at(x, jnp.arange(2, T, 2), parity=0)
    return final_map, x
