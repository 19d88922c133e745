"""Scaling-efficiency harness: the batched ICM sweep over mesh sizes.

On a multi-GPU host this measures true scaling; it can also run over
virtual CPU devices (--cpu) to validate the collective code path (CPU
times are not device numbers).

    python benchmarks/scaling.py [--devices 1 2 4 8] [--frames 0] [--cpu]

Prints one JSON line per mesh size:
    {"devices": n, "refine_ms": ..., "frames_per_s": ..., "efficiency": ...}
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    # os imported at module level
    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", f"--xla_force_host_platform_device_count="
                         f"{max(args.devices)}")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.data.datasets import reference_world
    from icm_slam_tpu.mapping.landmark_map import filter_map
    from icm_slam_tpu.parallel.mesh import (make_mesh, replicated,
                                            shard_sweep_inputs, time_sharding)
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit, prepare,
                                         resolve_config, seed_map)
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    ds = reference_world()
    if args.frames:
        ds = ds.slice(args.frames)
    cfg = ICMConfig(N=1, L=1024, dtype="float32")
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    state, x, _ = _init_jit(data, seed, x0, cfg)
    cur = _filter_jit(state, cfg)
    w = weights(cfg)
    # efficiency is normalized to the SMALLEST measured mesh (its cost x its
    # size); measure 1 device too if you want absolute efficiency
    devices = sorted(set(args.devices))
    base_cost = None
    base_n = None

    for n in devices:
        if n > len(jax.devices()):
            print(json.dumps({"devices": n, "skipped": "not enough devices"}))
            continue
        mesh = make_mesh(n_devices=n)
        data_s, x_s, true_T = shard_sweep_inputs(mesh, data, x)
        cur_s = jax.device_put(cur, replicated(mesh))
        ts, rep = time_sharding(mesh), replicated(mesh)

        @jax.jit
        def step(d, m, xx):
            st, xx = refine_sweep_batched(d, m, xx, cfg, w,
                                          last_t=true_T - 1)
            xx = jax.lax.with_sharding_constraint(xx, ts)
            fm = jax.tree.map(
                lambda a: jax.lax.with_sharding_constraint(a, rep),
                filter_map(st, cfg.cota, cfg.dist_thr))
            return fm, xx

        fm, xo = step(data_s, cur_s, x_s)
        jax.block_until_ready(xo)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fm, xo = step(data_s, cur_s, x_s)
        jax.block_until_ready(xo)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        if base_cost is None:
            base_cost = ms * n
            base_n = n
        eff = base_cost / (ms * n) if ms > 0 else 0.0
        print(json.dumps({
            "devices": n, "refine_ms": round(ms, 2),
            "frames_per_s": round(true_T / (ms / 1e3), 1),
            "efficiency": round(eff, 3),
            "efficiency_relative_to": base_n,
        }))


if __name__ == "__main__":
    main()
