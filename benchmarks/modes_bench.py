"""Alternative-backend timing: per-iter cost + ATE for every sweep_mode.

The headline bench (icm_slam_tpu/benchmarks/headline.py) measures the
production `batched` mode; this harness measures the alternative
backends (`windowed_ba` 64-keyframe joint GN blocks, `ba` full-chain
Schur/PCG, `sequential` reference-fidelity Gauss-Seidel) with the same
protocol as the headline bench: chained state, median of reps, compile
excluded by warmup, ATE vs the golden trace self-reported.

    python benchmarks/modes_bench.py [--modes windowed_ba,ba,sequential]
                                     [--iters 30] [--seq-iters 6] [--cpu]

Prints a cumulative JSON line after each completed mode (a harness
timeout mid-run leaves the partial record as the last stdout line).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="windowed_ba,ba,sequential")
    ap.add_argument("--dataset", default="reference")
    ap.add_argument("--iters", type=int, default=30,
                    help="sweeps per timed call for the fused modes (30 = "
                         "golden depth, so the ATE row is free)")
    ap.add_argument("--seq-iters", type=int, default=6,
                    help="timed sweeps for the sequential mode (it runs "
                         "per-iteration programs at ~0.5 s/sweep; its ATE "
                         "run still uses the full 30)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--frames", type=int, default=0,
                    help="slice the dataset (smoke runs); disables the "
                         "ATE row, which is only valid at full depth")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found; pass --cpu for a CPU run")
    import jax.numpy as jnp
    import numpy as np

    from icm_slam_tpu.benchmarks.headline import _golden_path
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import load
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit,
                                         _refine_jit, _refine_loop_jit,
                                         hoist_compaction, prepare,
                                         resolve_config, seed_map)

    ds = load(args.dataset)
    if args.frames:
        ds = ds.slice(args.frames)
    gp = None if args.frames else _golden_path(args.dataset)
    gx = np.load(gp)["x"].T if gp else None

    results = {}
    out = {"metric": "sweep_mode_bench", "dataset": args.dataset,
           "iters": args.iters, "modes": results}
    for mode in [m for m in args.modes.split(",") if m]:
        cfg = ICMConfig(N=args.iters, L=1024, dtype="float32",
                        sweep_mode=mode)
        data = prepare(ds, cfg)
        cfg = resolve_config(cfg, data)
        x0 = jnp.asarray(ds.x0, data.dist.dtype)
        seed = seed_map(data, x0, cfg)
        state, x, _ = _init_jit(data, seed, x0, cfg)
        cur_map = _filter_jit(state, cfg)
        # bench.py's protocol: hoist the loop-invariant compaction out of
        # the timed programs (no-op for sequential mode, which keeps the
        # shared 1-D beam vector)
        data = hoist_compaction(data, cfg)

        from icm_slam_tpu.benchmarks.timing import timed_chained_median_s
        x30 = None
        if mode == "sequential":
            # per-iteration programs (no fused loop for this mode); time
            # a chained run of --seq-iters sweeps, ATE from a full-30 run
            jax.block_until_ready(_refine_jit(data, cur_map, x, cfg))
            m, xx = cur_map, x
            t0 = time.perf_counter()
            for _ in range(args.seq_iters):
                m, xx, _ = _refine_jit(data, m, xx, cfg)
            jax.block_until_ready(xx)
            it_s = (time.perf_counter() - t0) / max(args.seq_iters, 1)
            if gx is not None:
                for _ in range(30 - args.seq_iters):
                    m, xx, _ = _refine_jit(data, m, xx, cfg)
                x30 = np.asarray(xx)
        else:
            m_w, x_w, _, _ = _refine_loop_jit(data, cur_map, x, cfg,
                                              args.iters,
                                              with_metrics=False)
            jax.block_until_ready(x_w)  # compile + warmup
            if gx is not None:
                if args.iters == 30:
                    x30 = np.asarray(x_w)  # warmup state IS golden depth
                else:
                    # the reported key is ATE at EXACTLY 30 sweeps — any
                    # other --iters gets a dedicated run (headline.py's
                    # "the key never lies" contract)
                    _, x30j, _, _ = _refine_loop_jit(data, cur_map, x,
                                                     cfg, 30,
                                                     with_metrics=False)
                    x30 = np.asarray(x30j)
            med_s, _, _ = timed_chained_median_s(
                lambda mm, xs: _refine_loop_jit(
                    data, mm, xs, cfg, args.iters, with_metrics=False)[:2],
                m_w, x_w, args.reps)
            it_s = med_s / args.iters

        row = {"ms_per_iter": round(it_s * 1e3, 2),
               "frames_per_s": round(ds.T / it_s, 0)}
        if gx is not None:
            row["ate_vs_reference_m_at_n30"] = round(float(np.mean(
                np.linalg.norm(x30[:, :2] - gx[:, :2], axis=1))), 4)
        results[mode] = row
        print(f"# {mode}: {row}", file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
