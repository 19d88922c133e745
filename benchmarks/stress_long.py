"""Long-trajectory stress benchmark: synthetic worlds far beyond the
reference's 1833 frames, single chip.

    python benchmarks/stress_long.py [--frames 20000] [--landmarks 300]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--profile",
                    choices=["fast", "default", "turbo", "ultra", "max"],
                    default="default",
                    help="refine knob preset (the historical stress metric "
                         "is the conservative default profile)")
    ap.add_argument("--cap", type=int, default=128,
                    help="map_run_cap in CHECKED mode (runtime-witnessed, "
                         "exact-or-error: an undersized cap raises instead "
                         "of truncating); 0 = full-width paths")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found; pass --cpu for a CPU run")
    import json

    import jax.numpy as jnp
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import synthetic_world
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit, _refine_jit,
                                         check_witness, hoist_compaction,
                                         kept_count, prepare, resolve_config,
                                         seed_map)

    t0 = time.perf_counter()
    ds = synthetic_world(T=args.frames, n_landmarks=args.landmarks,
                         world_size=120.0, seed=0)
    gen_s = time.perf_counter() - t0

    # the cota bound (total_obs / 50 >> L) would disable the cap outright,
    # but the world only holds ~300 landmarks: CHECKED cap mode keeps the
    # fast cap-sliced association/filter paths and every sweep's witness
    # verifies the survivor count stayed under it (exact-or-error)
    p, g = {"fast": (1, 6), "default": (2, 8), "turbo": (1, 3),
            "ultra": (1, 2), "max": (1, 1)}[args.profile]
    cfg = ICMConfig(N=args.iters, L=1024, cota=50.0, dtype="float32",
                    pose_passes=p, pose_gn_iters=g,
                    map_run_cap=args.cap,
                    map_run_cap_checked=args.cap > 0)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)

    t0 = time.perf_counter()
    state, x, raw_nact = _init_jit(data, seed, x0, cfg)
    jax.block_until_ready(x)
    init_s = time.perf_counter() - t0
    # witness on the PRE-merge raw count (same as run(), solver/icm.py):
    # the batched init compacts state.nact to <= L, so an overflow would be
    # invisible in post-merge state — exactly at this 20k-frame stress site
    check_witness(jnp.stack([raw_nact.astype(jnp.int32),
                             kept_count(state, cfg.cota)]), cfg, "init sweep")
    cur = _filter_jit(state, cfg)

    # same loop-invariant compaction hoist run() applies before its
    # refinement loop — the per-iteration protocol otherwise re-runs the
    # (T, 181) validity sort every sweep
    data = hoist_compaction(data, cfg)

    m, xx, _ = _refine_jit(data, cur, x, cfg)  # warmup/compile
    jax.block_until_ready(xx)
    t0 = time.perf_counter()
    m, xx = cur, x
    witnesses = []
    for _ in range(args.iters):
        m, xx, w = _refine_jit(data, m, xx, cfg)
        witnesses.append(w)
    jax.block_until_ready(xx)
    refine_s = (time.perf_counter() - t0) / args.iters
    for k, w in enumerate(witnesses):
        check_witness(w, cfg, f"refinement sweep {k}")

    print(json.dumps({
        "frames": args.frames,
        "profile": args.profile,
        "landmarks_world": args.landmarks,
        "landmarks_mapped": int(m.nact),
        "gen_s": round(gen_s, 1), "init_s": round(init_s, 2),
        "refine_ms_per_iter": round(refine_s * 1e3, 1),
        "refine_frames_per_s": round(args.frames / refine_s, 0),
    }))


if __name__ == "__main__":
    main()
