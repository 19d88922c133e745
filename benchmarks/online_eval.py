"""Online (streaming) engine performance: sustained push() throughput and
finish() latency.

The online engine is equivalence-tested; this gives it a performance
number — online operation is the reference's whole
raison d'être (ICM_ROS.py:47-100 busy-waits on a 10 Hz rosbridge feed,
createbag.py:144).  This measures, on the real dataset:

* sustained streaming throughput: all T frames pushed one-by-one through
  ``OnlineSLAM.push()`` (host filter + jitted causal chunk per ``chunk``
  frames), wall-clocked end to end AFTER a warmup session has compiled the
  chunk program — the steady-state rate a feeder could sustain;
* ``finish(refine=True)`` latency: map filter + the full N=30 fused
  refinement loop, i.e. how long after the stream stops until the final
  refined trajectory exists;
* the headroom multiple over the reference's 10 Hz live feed;
* ATE vs the reference golden trace as the quality self-check.

Usage: python benchmarks/online_eval.py [--chunk 64] [--cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))


def stream_all(ds, config, chunk, verbose=False):
    from icm_slam_tpu.runtime.online import OnlineSLAM
    eng = OnlineSLAM(config, chunk_size=chunk, verbose=verbose)
    t0 = time.perf_counter()
    for t in range(ds.T):
        eng.push(ds.scans[t], ds.odom[t], ds.u[t])
    stream_s = time.perf_counter() - t0
    return eng, stream_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ijac2018")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import load

    ds = load(args.dataset)
    cfg = ICMConfig(N=args.iters, L=1024, dtype="float32")

    # warmup session: compiles the chunk program + the finish() programs.
    # Must stream the FULL T and refine at the measured n_iters — the
    # refine loop is jitted with static (shapes, n_iters), so a smaller
    # warmup would leave the measured finish() compile-dominated
    eng_w, _ = stream_all(ds, cfg, args.chunk)
    eng_w.finish(refine=True, n_iters=args.iters)

    # measured session (fresh engine; programs warm)
    eng, stream_s = stream_all(ds, cfg, args.chunk)
    t0 = time.perf_counter()
    res = eng.finish(refine=True, n_iters=args.iters)
    finish_s = time.perf_counter() - t0

    ate = None
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "tests", "golden",
                          f"{args.dataset}_T1833_N30_inconsistent.npz")
    if ds.T == 1833 and args.iters == 30 and os.path.exists(golden):
        gx = np.load(golden)["x"].T
        ate = float(np.mean(np.linalg.norm(res.x[:, :2] - gx[:, :2],
                                           axis=1)))

    out = {
        "metric": "online_stream_frames_per_s",
        "value": round(ds.T / stream_s, 1),
        "unit": "frames/s",
        "chunk": args.chunk,
        "headroom_vs_10hz_feed": round(ds.T / stream_s / 10.0, 1),
        "finish_refine_s": round(finish_s, 3),
        "frames": ds.T,
    }
    if ate is not None:
        out["ate_vs_reference_m_at_n30"] = round(ate, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
