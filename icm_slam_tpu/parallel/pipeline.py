"""Pipeline parallelism (PP) over a device mesh — the SURVEY §2.3 PP row.

The reference has no parallelism at all (single Python thread); SURVEY
marks PP "optional: pipeline scan-filter → association → optimize stages
across cores".  This module is its realization: a GPipe-style
software pipeline where each device of a 1-D ``stage`` mesh axis owns one
processing stage, microbatches (chunks of frames) ride a ``ppermute`` ring
through the stages, and ``lax.switch`` dispatches each device's resident
stage function — the standard XLA-collective pipeline pattern, no NCCL/MPI.

Honest engineering note: for THIS workload the barrier-
free decomposition is data/sequence parallelism over the time axis
(`parallel/mesh.py`) — every stage of the ICM sweep is already a batched
op over frames, so PP buys nothing on a homogeneous slice.  PP exists
here as the validated scaffold for heterogeneous-stage deployments
(e.g. devices dedicated to ingest-side filtering vs pose optimization)
and to keep the parallelism inventory complete.  `pipelined_refine_pass`
is asserted equal to the barrier sweep (tests/test_pipeline.py).
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, devices=None) -> Mesh:
    """1-D mesh whose axis enumerates pipeline stages (one device each)."""
    import numpy as np
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_stages]), (STAGE_AXIS,))


def pipeline_stages(mesh: Mesh, stage_fns: Sequence[Callable],
                    make_payload: Callable, n_chunks: int, consts,
                    extract: Callable = lambda p: p):
    """Run ``n_chunks`` microbatches through ``len(stage_fns)`` stages.

    GPipe schedule on the ``stage`` axis: at tick t, stage s processes
    chunk t-s; payloads advance one stage per tick on a ppermute ring.
    Fill + drain = n_chunks + S - 1 ticks; steady state keeps all S
    devices busy on S consecutive chunks.

    ``make_payload(consts, i)`` builds chunk i's initial payload (a pytree
    whose structure/shapes are identical for every chunk — the ring
    requires a uniform payload).  ``stage_fns[s](consts, payload)`` must
    return a payload of the same structure.  ``consts`` is a pytree of
    replicated arrays every stage may read (closures cannot be relied on
    inside shard_map).

    Returns ``extract(payload)`` of each chunk's final-stage payload,
    stacked on a leading (n_chunks,) axis, replicated across the mesh.
    """
    S = mesh.shape[STAGE_AXIS]
    if len(stage_fns) != S:
        raise ValueError(f"{len(stage_fns)} stages for a {S}-device mesh")
    stage_fns = list(stage_fns)

    def spmd(consts):
        sid = jax.lax.axis_index(STAGE_AXIS)
        template = jax.tree.map(jnp.zeros_like, make_payload(consts, 0))
        out0 = jax.tree.map(
            lambda a: jnp.zeros((n_chunks,) + a.shape, a.dtype),
            extract(template))
        perm = [(i, (i + 1) % S) for i in range(S)]

        def tick(carry, t):
            payload, outbuf = carry
            # inject: stage 0 picks up chunk t (drain ticks recompute the
            # last chunk; their results fall past the extract window)
            fresh = make_payload(consts, jnp.minimum(t, n_chunks - 1))
            payload = jax.tree.map(
                lambda a, b: jnp.where(sid == 0, a, b), fresh, payload)
            payload = jax.lax.switch(
                sid, stage_fns, consts, payload)
            # extract: the last stage just finished chunk t - (S-1)
            c = t - (S - 1)
            take = (sid == S - 1) & (c >= 0)
            cc = jnp.maximum(c, 0)
            outbuf = jax.tree.map(
                lambda buf, v: jnp.where(
                    take, jax.lax.dynamic_update_index_in_dim(buf, v, cc, 0),
                    buf),
                outbuf, extract(payload))
            payload = jax.lax.ppermute(payload, STAGE_AXIS, perm)
            return (payload, outbuf), None

        (_, outbuf), _ = jax.lax.scan(
            tick, (template, out0), jnp.arange(n_chunks + S - 1))
        # only the last stage's buffer is populated -> psum replicates it
        return jax.lax.psum(outbuf, STAGE_AXIS)

    # check_vma off: stage_fns may call solvers whose internal scans mix
    # replicated constants into device-varying carries (e.g. lm_minimize's
    # initial damping) — correct SPMD, but the varying-axes type checker
    # cannot see it
    return shard_map(spmd, mesh=mesh, in_specs=(P(),), out_specs=P(),
                     check_vma=False)(consts)


# ---------------------------------------------------------------------------
# application: the refine half-pass as a 3-stage pipeline
#   stage 0  gather/pack   — slice the chunk's observations + neighbor poses
#   stage 1  optimize      — vmapped two-sided LM pose solves
#   stage 2  finalize      — last-frame one-sided override, empty-frame
#                            averaging, keep-masking (write-back rules)
# ---------------------------------------------------------------------------

def pipelined_refine_pass(data, old_map, x, config, w, mesh,
                          chunk: int = 64, last_t: int | None = None):
    """One ICM sweep (association + red-black poses) with the pose passes
    executed as a 3-stage pipeline over frame chunks.

    Same math as `solver.sweeps.refine_sweep_batched` — the frames of one
    parity are independent, so chunking + pipelining changes the schedule,
    not the algorithm (equal to within f32 reduction-order noise from the
    different vmap batch shapes).  Reference semantics: ICM_ROS.py:141-162.
    """
    from icm_slam_tpu.core.energy import (PoseProblem, one_sided_residuals,
                                          two_sided_residuals)
    from icm_slam_tpu.solver.gauss_newton import lm_minimize
    from icm_slam_tpu.solver.sweeps import (_jacs_of, _model_of,
                                            batched_associate, compact_data)

    T = x.shape[0]
    if last_t is None:
        last_t = T - 1
    empty = ~jnp.any(data.mask, axis=1)
    model = _model_of(config)
    jac1, jac2 = _jacs_of(config)
    # same fold as sweeps._solve_two_at: the last frame's ONE-SIDED solve
    # rides the vmapped two-sided batch (zeroed forward rows + kinematic
    # init) instead of a separate LM chain — which here ran once PER CHUNK
    # in stage_finalize, i.e. ceil(T/2/chunk) extra sequential LM scans per
    # half-pass.  Gated on the default [forward(6), backward] stacking.
    fold_last = (model.two_sided is None and model.extra_two_sided is None
                 and jac2 is None)

    cap = config.obs_cap if config.obs_cap else data.dist.shape[1]
    if cap < data.dist.shape[1]:
        data_c = compact_data(data, cap)
    else:
        data_c = data._replace(ang=jnp.broadcast_to(data.ang,
                                                    data.dist.shape))
    _, final_map, matched = batched_associate(data_c, old_map, x, config)

    def half_pass(x, parity):
        start = 1 if parity == 1 else 2
        ts_all = jnp.arange(start, T, 2)
        K = ts_all.shape[0]
        n_chunks = -(-K // chunk)
        # pad with frame 0 (never a solve target; write-back is a no-op)
        ts_pad = jnp.concatenate(
            [ts_all, jnp.zeros((n_chunks * chunk - K,), ts_all.dtype)])
        consts = dict(x=x, ts=ts_pad.reshape(n_chunks, chunk),
                      dist=data_c.dist, ang=data_c.ang,
                      mask=data_c.mask, matched=matched,
                      odom=data.odom, u=data.u, empty=empty, w=w)

        def prob_at(c, t):
            tm1 = jnp.maximum(t - 1, 0)
            tp1 = jnp.minimum(t + 1, T - 1)
            return PoseProblem(
                dist=c["dist"][t], ang=c["ang"][t], mask=c["mask"][t],
                matched=c["matched"][t], x_prev=c["x"][tm1],
                u_prev=c["u"][tm1], odo_prev=c["odom"][tm1],
                odo_cur=c["odom"][t], x_next=c["x"][tp1], u_cur=c["u"][t],
                odo_next=c["odom"][tp1])

        def stage_gather(c, p):
            ts = c["ts"][p["i"]]
            prob = jax.vmap(lambda t: prob_at(c, t))(ts)
            x_init = (prob.x_prev + prob.x_next) / 2.0
            if fold_last:
                kin = jax.vmap(
                    lambda pr: model.kinematics(pr.x_prev, pr.u_prev,
                                                config.deltat))(prob)
                x_init = jnp.where((ts == last_t)[:, None], kin, x_init)
            return {**p, "ts": ts, "prob": prob, "x_init": x_init}

        def stage_optimize(c, p):
            cw = c["w"]

            def solve(prob, x0, is_last):
                def resid(xx):
                    r = two_sided_residuals(xx, prob, cw, model)
                    if not fold_last:
                        return r
                    head = jnp.arange(r.shape[0]) < 6
                    return jnp.where(is_last & head, 0.0, r)
                return lm_minimize(
                    resid, x0, iters=config.pose_gn_iters,
                    jac_fn=None if jac2 is None else
                    (lambda xx: jac2(xx, prob, cw)))
            cand = jax.vmap(solve)(p["prob"], p["x_init"],
                                   p["ts"] == last_t)
            return {**p, "cand": cand}

        def stage_finalize(c, p):
            ts, cand = p["ts"], p["cand"]
            if not fold_last:
                # legacy path (custom two-sided energies): one-sided cost at
                # the trajectory's last real frame (ICM_ROS.py:153-156) as
                # one extra solve per chunk, selected in
                in_chunk = jnp.any(ts == last_t)
                t_last = jnp.asarray(last_t)
                tm1 = jnp.maximum(t_last - 1, 0)
                z3 = jnp.zeros((3,), x.dtype)
                prob1 = PoseProblem(
                    dist=c["dist"][t_last], ang=c["ang"][t_last],
                    mask=c["mask"][t_last], matched=c["matched"][t_last],
                    x_prev=c["x"][tm1], u_prev=c["u"][tm1],
                    odo_prev=c["odom"][tm1], odo_cur=c["odom"][t_last],
                    x_next=z3, u_cur=jnp.zeros((2,), x.dtype), odo_next=z3)
                cw = c["w"]
                one = lm_minimize(
                    lambda xx: one_sided_residuals(xx, prob1, cw, model),
                    model.kinematics(c["x"][tm1], c["u"][tm1],
                                     config.deltat),
                    iters=config.pose_gn_iters,
                    jac_fn=None if jac1 is None else
                    (lambda xx: jac1(xx, prob1, cw)))
                cand = jnp.where(((ts == last_t) & in_chunk)[:, None],
                                 one[None, :], cand)
            tm1s = jnp.maximum(ts - 1, 0)
            tp1s = jnp.minimum(ts + 1, last_t)
            x_avg = (c["x"][tm1s] + c["x"][tp1s]) / 2.0
            cand = jnp.where(c["empty"][ts][:, None], x_avg, cand)
            keep = (ts <= last_t) & (ts >= start)
            cand = jnp.where(keep[:, None], cand, c["x"][ts])
            return {**p, "cand": cand}

        z3k = jnp.zeros((chunk, 3), x.dtype)

        def make_payload(c, i):
            prob0 = PoseProblem(
                dist=jnp.zeros_like(c["dist"][:chunk]),
                ang=jnp.zeros_like(c["ang"][:chunk]),
                mask=jnp.zeros_like(c["mask"][:chunk]),
                matched=jnp.zeros_like(c["matched"][:chunk]),
                x_prev=z3k, u_prev=jnp.zeros((chunk, 2), x.dtype),
                odo_prev=z3k, odo_cur=z3k, x_next=z3k,
                u_cur=jnp.zeros((chunk, 2), x.dtype), odo_next=z3k)
            return {"i": jnp.asarray(i, jnp.int32),
                    "ts": jnp.zeros((chunk,), c["ts"].dtype),
                    "prob": prob0, "x_init": z3k, "cand": z3k}

        out = pipeline_stages(
            mesh, [stage_gather, stage_optimize, stage_finalize],
            make_payload, n_chunks, consts,
            extract=lambda p: {"ts": p["ts"], "cand": p["cand"]})
        ts_flat = out["ts"].reshape(-1)
        cand_flat = out["cand"].reshape(-1, 3)
        return x.at[ts_flat].set(cand_flat)

    for _ in range(config.pose_passes):
        x = half_pass(x, 1)
        x = half_pass(x, 0)
    return final_map, x
