"""High-level user API: the reference's entry points.

``run_offline``  — entry point C equivalent (.mat replay through the full
                   pipeline: init + N ICM iterations), with optional
                   checkpoint/resume and JSON-lines metrics.
``run_online``   — entry point A equivalent: consume a frame stream (replay
                   feeder or live adapter) causally, then refine offline.

Both accept reference-format YAML configs (ICMConfig.from_yaml).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import Dataset, load
from icm_slam_tpu.solver.icm import ICMResult, run, run_batched
from icm_slam_tpu.utils import checkpoint as ckpt
from icm_slam_tpu.utils.metrics import JsonlLogger, ate


def run_offline(dataset, config: Optional[ICMConfig] = None,
                checkpoint_dir: Optional[str] = None,
                resume: bool = False,
                log_path: Optional[str] = None,
                verbose: bool = False,
                live_plot=None,
                checkpoint_every: int = 5) -> ICMResult:
    """Full offline pipeline on a Dataset (or dataset name/path).

    ``live_plot``: a ``utils.viz.LivePlot`` (or True for a default one) —
    re-plots trajectory + map after EVERY ICM iteration, the reference's
    per-iteration graficar2 loop (ICM_ROS.py:304,313-315).

    ``checkpoint_every``: when ONLY ``checkpoint_dir`` is set (no logger /
    live plot), the refinement runs as fused K-iteration device programs
    with a checkpoint at each segment boundary — one-program throughput at
    K-iteration crash granularity instead of paying the per-iteration
    dispatch tax (~13% at the fast profile).  A per-iteration observer
    (logger/live_plot) forces K=1.
    """
    if isinstance(dataset, str):
        dataset = load(dataset)
    if live_plot is True:
        from icm_slam_tpu.utils.viz import LivePlot
        live_plot = LivePlot()
    elif live_plot is False:   # a natural "no plot" spelling — same as None
        live_plot = None
    config = config or ICMConfig()
    logger = JsonlLogger(log_path) if (log_path or verbose) else None
    try:
        return _run_offline(dataset, config, checkpoint_dir, resume,
                            logger, verbose, live_plot, checkpoint_every)
    finally:
        if logger:       # append-mode file handle — don't leak one per run
            logger.close()


def _run_offline(dataset, config, checkpoint_dir, resume, logger, verbose,
                 live_plot, checkpoint_every) -> ICMResult:
    start_iter = 0
    if resume and checkpoint_dir:
        path = ckpt.latest(checkpoint_dir)
        if path:
            state = ckpt.load(path)
            start_iter = int(state["iteration"]) + 1
            if logger:
                logger.log("resume", path=path, start_iter=start_iter)
            # resume = rerun remaining iterations from the checkpointed state
            return _resume_run(dataset, config, state, start_iter,
                               checkpoint_dir, logger,
                               checkpoint_every=checkpoint_every)

    # only attach a per-iteration callback when it has work to do — with
    # no observer run() fuses the whole refinement loop into one device
    # program (solver.icm._refine_loop_jit); checkpoint-only runs keep the
    # fused path in K-iteration segments (callback_stride)
    per_iter_observer = bool(logger or live_plot is not None)
    needs_cb = bool(checkpoint_dir or per_iter_observer)
    stride = 1 if per_iter_observer else max(int(checkpoint_every), 1)

    def cb(k, cur_map, x):
        if checkpoint_dir:
            nact = int(cur_map.nact)
            ckpt.save(os.path.join(checkpoint_dir, f"icm_ckpt_{k}.npz"),
                      k, np.asarray(x), np.asarray(cur_map.pos[:nact]),
                      np.asarray(cur_map.counts[:nact]), nact)
        if logger:
            logger.log("iteration", k=k, landmarks=int(cur_map.nact))
        if live_plot is not None:
            live_plot.update(np.asarray(x),
                             np.asarray(cur_map.pos[:int(cur_map.nact)]),
                             odom=dataset.odom)

    def on_init(x_init):
        # persist the iteration-0 trajectory IMMEDIATELY (before any
        # refinement): a resume after a mid-run crash — the primary
        # checkpoint scenario — must still report corrections against it
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.savez_compressed(os.path.join(checkpoint_dir, "x_init.npz"),
                                x_init=x_init)

    result = run(dataset, config, verbose=verbose,
                 callback=cb if needs_cb else None, on_init=on_init,
                 callback_stride=stride)
    if logger:
        logger.log("done", landmarks=result.map_pos.shape[0],
                   timings=result.timings,
                   ate_vs_odom=ate(result.x, dataset.odom))
    return result


def _resume_run(dataset: Dataset, config: ICMConfig, state: dict,
                start_iter: int, checkpoint_dir, logger,
                checkpoint_every: int = 5) -> ICMResult:
    import jax.numpy as jnp
    from icm_slam_tpu.mapping.landmark_map import MapState
    from icm_slam_tpu.solver.icm import (_refine_loop_jit, check_witness,
                                         hoist_compaction, prepare,
                                         resolve_config)

    data = prepare(dataset, config)
    config = resolve_config(config, data)
    # same loop-invariant compaction hoist as run(): without it a logger
    # (stride 1) would re-run the (T, B) validity argsort every sweep
    data = hoist_compaction(data, config)
    dtype = data.dist.dtype
    L = config.L
    pos = jnp.zeros((L, 2), dtype).at[:state["map_pos"].shape[0]].set(
        jnp.asarray(state["map_pos"], dtype))
    counts = jnp.zeros((L,), dtype).at[:state["map_counts"].shape[0]].set(
        jnp.asarray(state["map_counts"], dtype))
    cur_map = MapState(pos, counts, jnp.asarray(int(state["nact"]), jnp.int32))
    x = jnp.asarray(state["x"], dtype)
    x_init = state.get("x_init")
    if x_init is None and checkpoint_dir:
        init_path = os.path.join(checkpoint_dir, "x_init.npz")
        if os.path.exists(init_path):
            with np.load(init_path) as z:
                x_init = z["x_init"]
    if x_init is None:
        x_init = np.asarray(x)

    # same segmented fused loop as run_offline's checkpoint path: per-
    # iteration witnesses/changes come back from inside each segment, the
    # checkpoint lands at segment boundaries.  A logger forces stride 1.
    stride = max(int(checkpoint_every), 1) if not logger else 1
    changes = []
    import time as _time
    t0 = _time.perf_counter()
    k = start_iter
    while k < config.N:
        seg = min(stride, config.N - k)
        cur_map, x, wit, chg = _refine_loop_jit(data, cur_map, x, config,
                                                seg)
        wit = np.asarray(wit)
        for j in range(seg):
            check_witness(wit[j], config, f"refinement sweep {k + j}")
        changes.extend(np.asarray(chg).tolist())
        k += seg
        if checkpoint_dir:
            nact = int(cur_map.nact)
            ckpt.save(os.path.join(checkpoint_dir, f"icm_ckpt_{k - 1}.npz"),
                      k - 1, np.asarray(x), np.asarray(cur_map.pos[:nact]),
                      np.asarray(cur_map.counts[:nact]), nact)
        if logger:
            logger.log("iteration", k=k - 1, landmarks=int(cur_map.nact))
    refine_s = _time.perf_counter() - t0

    nact = int(cur_map.nact)
    n_done = max(config.N - start_iter, 1)
    return ICMResult(
        x_init=np.asarray(x_init), x=np.asarray(x),
        map_pos=np.asarray(cur_map.pos[:nact]),
        map_counts=np.asarray(cur_map.counts[:nact]),
        changes=np.asarray(changes),
        timings={"refine_s": refine_s,
                 "refine_per_iter_s": refine_s / n_done})


def run_online(stream, config: Optional[ICMConfig] = None,
               refine: bool = True, verbose: bool = False) -> ICMResult:
    """Online pipeline: causal init over a frame stream, then offline refine.

    ``stream`` is any iterable of (ranges, odom, u) frame tuples — see
    icm_slam_tpu.runtime.replay / icm_slam_tpu.runtime.ingest.
    """
    from icm_slam_tpu.runtime.online import OnlineSLAM
    config = config or ICMConfig()
    eng = OnlineSLAM(config, verbose=verbose)
    for frame in stream:
        eng.push(*frame)
    return eng.finish(refine=refine)
