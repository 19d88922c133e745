"""Fleet scaling curve: refine-loop throughput vs replicated world count W.

A single reference-scale run is latency-bound: the device idles through
the sweep's sequential dependency chain, so extra *parallel* worlds per
step should be nearly free until that headroom is consumed.  This harness
measures it: W replicated reference-shape worlds through one vmapped
fused refine loop (solver.icm's fleet path), per-world ms/iter and
aggregate frames/s vs W.

    python benchmarks/fleet_curve.py [--ws 1,2,4,8,16,32,64] [--iters 30]

Prints a CUMULATIVE JSON line after each completed W, so a harness timeout
mid-curve still leaves the partial curve as the last stdout line.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ws", default="1,2,4,8,16,32,64",
                    help="comma-separated world counts to measure")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed chained reps per W; median reported")
    ap.add_argument("--dataset", default="reference")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--profile",
                    choices=["fast", "default", "turbo", "ultra", "max"],
                    default="fast")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found; pass --cpu for a CPU run")
    import jax.numpy as jnp

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import load
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit,
                                         _refine_loop_jit, hoist_compaction,
                                         prepare, resolve_config, seed_map)

    passes, gn_iters = {"default": (2, 8), "turbo": (1, 3),
                        "ultra": (1, 2), "max": (1, 1),
                        "fast": (1, 6)}[args.profile]
    cfg = ICMConfig(N=args.iters, L=1024, dtype="float32",
                    pose_passes=passes, pose_gn_iters=gn_iters)
    ds = load(args.dataset)
    T = ds.T
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    state, x, _ = _init_jit(data, seed, x0, cfg)
    cur_map = _filter_jit(state, cfg)
    # same protocol as bench.py's fleet row: hoist the loop-invariant beam
    # compaction BEFORE replicating — the fused loop's internal hoist
    # no-ops on the result, and the W replicas carry ~cap beams, not B=181
    data = hoist_compaction(data, cfg)

    def fleet_loop_fn(n_iters):
        @jax.jit
        def fleet_loop(d, mm, xs):
            return jax.vmap(lambda di, mi, xi: _refine_loop_jit(
                di, mi, xi, cfg, n_iters, with_metrics=False))(d, mm, xs)
        return fleet_loop

    rows = []
    out = {"metric": "fleet_scaling_curve", "dataset": args.dataset,
           "profile": args.profile, "iters_per_call": args.iters,
           "frames": T, "rows": rows}
    base_ms = None
    for W in [int(w) for w in args.ws.split(",") if w]:
        rep = lambda a: jnp.stack([a] * W)
        data_b = jax.tree.map(rep, data)
        map_b = jax.tree.map(rep, cur_map)
        x_b = rep(x)
        loop = fleet_loop_fn(args.iters)
        t0 = time.perf_counter()
        mb, xb, _, _ = loop(data_b, map_b, x_b)   # compile + warmup
        jax.block_until_ready(xb)
        compile_s = time.perf_counter() - t0
        # chained-median protocol, shared helper
        from icm_slam_tpu.benchmarks.timing import timed_chained_median_s
        med_s, _, _ = timed_chained_median_s(
            lambda mm, xs: loop(data_b, mm, xs)[:2], mb, xb, args.reps)
        it_ms = med_s / args.iters * 1e3
        if base_ms is None:
            base_ms = it_ms if W == 1 else None
        row = {"W": W, "ms_per_iter": round(it_ms, 2),
               "per_world_ms_per_iter": round(it_ms / W, 3),
               "aggregate_frames_per_s": round(W * T / (it_ms / 1e3), 0),
               "compile_s": round(compile_s, 1)}
        if base_ms:
            row["throughput_vs_w1"] = round(base_ms * W / it_ms, 2)
        rows.append(row)
        print(f"# W={W}: {it_ms:.2f} ms/iter, "
              f"{row['aggregate_frames_per_s']:.0f} f/s aggregate",
              file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
