"""Roofline accounting for the headline sweep and the init, on the GPU.

* FLOPs and device-memory bytes per compiled program come from XLA's own
  cost model (``compiled.cost_analysis()`` — the totals for exactly the
  HLO that runs);
* a hand-derived per-stage breakdown (documented formulas below) splits
  those totals across the sweep's stages so the shares are inspectable;
* speed-of-light (SoL) time per program = max(flops / peak FLOP/s,
  bytes / peak bytes/s); actual/SoL is the headroom multiple.

Peaks come from ``PEAKS``, keyed by the device's ``device_kind``; a device
that is not in the table is an error.  The sweep is float32 with HIGHEST
precision matmuls, so the compute peak is the card's float32 rate outside
the tensor cores.  A program whose time is far above its SoL bound is not
compute- or bandwidth-bound: it is latency / launch / dependency-chain
bound, and the next speedup comes from fewer sequential steps.

Usage (needs the GPU):
  python benchmarks/roofline.py                      # analyze, no timing
  python benchmarks/roofline.py --measure            # also time it here
  python benchmarks/roofline.py --profile default --stress 20000 ...
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))

# Published per-card peaks: NVIDIA H100 data sheet, SXM part, dense rates,
# at the full 700 W power limit.  flops = float32 outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """The ``PEAKS`` row of a device kind; unknown devices are an error."""
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device kind "
                         f"{device_kind!r}; add them to PEAKS with their "
                         f"source")
    return PEAKS[device_kind]


def _cost(jitted, *args, **static):
    """(flops, bytes) from XLA's cost model for the compiled program."""
    lowered = jitted.lower(*args, **static)
    ca = lowered.compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def stage_table(T, B, K, L, G, P):
    """Hand-derived per-stage (flops, bytes) for ONE refinement sweep.

    Formulas (f32, 4 bytes/elem; counts are intentionally simple and
    slightly generous on the flop side — the XLA totals anchor the truth,
    this table only splits them into inspectable shares):

      T frames, B compacted beams/frame, K = map_run_cap live columns,
      L full table width, G LM iterations/pose, P red-black pass pairs.
    """
    st = []
    # beams_to_world: 2 trig + 4 mul/add per beam; read dist+ang+pose,
    # write (T,B,2) points
    st.append(("beams_to_world", T * B * 8, 4 * (T * B * 4 + T * B * 2)))
    # association: (T,B,K) squared distances + argmin (fused: the matrix
    # never reaches device memory; reads points + K reference columns,
    # writes labels)
    st.append(("assoc distance+argmin", T * B * K * 5,
               4 * (T * B * 2 + 2 * K + T * B)))
    # one-hot build + (B,K+1)x(B,3) matmul contraction per frame
    st.append(("one-hot sums (matmul)", 2 * T * B * (K + 1) * 3,
               4 * (T * B * (K + 1) + T * B * 3 + T * 3 * (K + 1))))
    # fused (T,3,K) prefix sum + running means
    st.append(("prefix sums + means", T * 3 * K + 2 * T * K,
               4 * (2 * T * 3 * K)))
    # matched gather (T,B) from (T,K) planes
    st.append(("matched gather", T * B * 2, 4 * (2 * T * K + T * B * 2)))
    # pose solves: m = 2B + 7 residual rows; per LM iter: jacfwd (3
    # tangents ~ 4x residual eval ~ 25 flops/row), J^T J (m*9*2), J^T r
    # (m*6), 3x3 solve (~100); P pass pairs x T poses x G iters
    m = 2 * B + 7
    per_pose_iter = m * (4 * 25 + 18 + 6) + 100
    st.append((f"LM solves ({P}x2 half-passes, G={G})",
               P * T * G * per_pose_iter,
               4 * (P * T * (B * 4 + 30))))
    # filter: KxK distance matrix + argmin + segment sums (relabel loop is
    # latency, ~0 flops)
    st.append(("filter_map (KxK merge)", 5 * K * K + 6 * K,
               4 * (3 * K * K / 2 + 6 * K)))
    return st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="reference")
    ap.add_argument("--profile",
                    choices=["fast", "default", "turbo", "ultra", "max"],
                    default="fast")
    ap.add_argument("--stress", type=int, default=0,
                    help="synthetic stress world with this many frames "
                         "instead of the reference dataset")
    ap.add_argument("--measure", action="store_true",
                    help="time the programs on this device (chained median)")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    pk = peaks(dev.device_kind)
    PEAK_FLOPS, PEAK_BW = pk["flops"], pk["bytes_per_s"]
    import jax.numpy as jnp

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import load, synthetic_world
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit, _refine_jit,
                                         _refine_loop_jit, prepare,
                                         resolve_config, seed_map)
    from icm_slam_tpu.solver.sweeps import compact_data

    if args.stress:
        ds = synthetic_world(T=args.stress, n_landmarks=120,
                             world_size=240.0, seed=0)
    else:
        ds = load(args.dataset)
    p, g = {"fast": (1, 6), "default": (2, 8), "turbo": (1, 3),
            "ultra": (1, 2), "max": (1, 1)}[args.profile]
    cfg = ICMConfig(N=args.iters, L=1024, dtype="float32",
                    pose_passes=p, pose_gn_iters=g)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    seed = seed_map(data, x0, cfg)
    T = ds.T
    B = cfg.obs_cap or data.dist.shape[1]
    K = cfg.map_run_cap or cfg.L

    # ---- XLA cost model totals --------------------------------------------
    # NOTE: XLA's cost model counts a lax.scan/while body ONCE regardless of
    # trip count, so costing _refine_loop_jit(n_iters=N) would NOT scale with
    # N.  Instead we cost the single-sweep program directly, twice:
    #   (a) standalone (includes the per-call beam-compaction prologue);
    #   (b) on pre-compacted data — the compaction guard no-ops, so this is
    #       exactly the per-iteration body of the fused loop.
    f_init, b_init = _cost(_init_jit, data, seed, x0, config=cfg)
    state, x, _ = _init_jit(data, seed, x0, cfg)
    cur_map = _filter_jit(state, cfg)
    f_ref, b_ref = _cost(_refine_jit, data, cur_map, x, config=cfg)
    data_c = (compact_data(data, B) if B < data.dist.shape[1] else data)
    f_marg, b_marg = _cost(_refine_jit, data_c, cur_map, x, config=cfg)

    # ---- optional timing ---------------------------------------------------
    refine_s = init_s = None
    if args.measure:
        from icm_slam_tpu.benchmarks.timing import timed_chained_median_s
        m_w, x_w, _, _ = _refine_loop_jit(data, cur_map, x, cfg, args.iters,
                                          with_metrics=False)
        jax.block_until_ready(x_w)
        med_s, _, _ = timed_chained_median_s(
            lambda m, xx: _refine_loop_jit(data, m, xx, cfg, args.iters,
                                           with_metrics=False)[:2],
            m_w, x_w, 5)
        refine_s = med_s / args.iters
        inits = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(_init_jit(data, seed, x0, cfg))
            inits.append(time.perf_counter() - t0)
        inits.sort()
        init_s = inits[len(inits) // 2]

    # ---- report ------------------------------------------------------------
    def row(name, fl, by, t_s=None):
        ai = fl / by if by else float("inf")
        sol = max(fl / PEAK_FLOPS, by / PEAK_BW)
        r = {"program": name, "gflops": round(fl / 1e9, 3),
             "mbytes": round(by / 1e6, 2), "arith_intensity": round(ai, 2),
             "sol_us": round(sol * 1e6, 1),
             "bound": "compute" if fl / PEAK_FLOPS > by / PEAK_BW
                      else "bandwidth"}
        if t_s:
            r.update({
                "time_ms": round(t_s * 1e3, 3),
                "x_over_sol": round(t_s / sol, 1),
                "mfu_pct": round(100 * fl / t_s / PEAK_FLOPS, 3),
                "bw_util_pct": round(100 * by / t_s / PEAK_BW, 2),
            })
        return r

    rows = [
        row("init sweep (iteration 0)", f_init, b_init, init_s),
        row("refine sweep (standalone, incl. compaction)", f_ref, b_ref),
        row("refine sweep (per-iter body in fused loop)",
            f_marg, b_marg, refine_s),
    ]

    print(f"# roofline — dataset={ds.name} T={T} B(cap)={B} K(cap)={K} "
          f"L={cfg.L} profile={args.profile} (passes={p}, gn_iters={g})",
          file=sys.stderr)
    print(f"# peaks ({dev.device_kind}): {PEAK_FLOPS / 1e12:.0f} TFLOP/s "
          f"f32, {PEAK_BW / 1e9:.0f} GB/s", file=sys.stderr)
    hdr = ("| program | GFLOP | MB | AI | SoL µs | bound | ms | x/SoL "
           "| MFU % | BW % |")
    print(hdr, file=sys.stderr)
    print("|" + "---|" * 10, file=sys.stderr)
    for r in rows:
        print(f"| {r['program']} | {r['gflops']} | {r['mbytes']} "
              f"| {r['arith_intensity']} | {r['sol_us']} | {r['bound']} "
              f"| {r.get('time_ms', '-')} | {r.get('x_over_sol', '-')} "
              f"| {r.get('mfu_pct', '-')} | {r.get('bw_util_pct', '-')} |",
              file=sys.stderr)

    print("#\n# per-stage hand model (one refinement sweep):",
          file=sys.stderr)
    tot_f = tot_b = 0
    for name, fl, by in stage_table(T, B, K, cfg.L, g, p):
        tot_f += fl
        tot_b += by
        print(f"#   {name:42s} {fl / 1e9:8.3f} GFLOP  {by / 1e6:8.2f} MB",
              file=sys.stderr)
    print(f"#   {'TOTAL (hand model)':42s} {tot_f / 1e9:8.3f} GFLOP  "
          f"{tot_b / 1e6:8.2f} MB   (XLA: {f_marg / 1e9:.3f} GFLOP, "
          f"{b_marg / 1e6:.2f} MB)", file=sys.stderr)

    print(json.dumps({"metric": "roofline", "dataset": ds.name,
                      "profile": args.profile, "rows": rows}))


if __name__ == "__main__":
    main()
