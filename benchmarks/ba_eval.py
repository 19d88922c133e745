"""Ground-truth solver comparison: joint BA vs batched ICM.

Does the joint Gauss-Newton optimum ever beat ICM's coordinate-descent
fixed point?  This harness answers with data: synthetic worlds with KNOWN
true trajectories + landmarks, swept over odometry-drift levels, plus the
golden comparison.

    python benchmarks/ba_eval.py [--cpu] [--T 600] [--iters 6]

Prints one JSON line per (drift, mode) cell:
    {"drift": d, "mode": m, "ate_vs_truth": ..., "lm_rmse": ...,
     "odom_ate": ..., "landmarks": n}
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--T", type=int, default=600)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--drifts", type=float, nargs="+",
                    default=[1e-3, 3e-3, 1e-2])
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import synthetic_world
    from icm_slam_tpu.solver.icm import run

    def ate(x, xt):
        return float(np.sqrt(((x[:, :2] - xt[:, :2]) ** 2).sum(1)).mean())

    def lm_rmse(mp, lt):
        d = np.sqrt(((mp[:, None, :] - lt[None, :, :]) ** 2).sum(-1))
        return float(d.min(1).mean()) if mp.size else float("nan")

    for drift in args.drifts:
        ds, xt, lt = synthetic_world(T=args.T, n_landmarks=25,
                                     seed=args.seed, odo_drift=drift,
                                     return_truth=True)
        base = ate(ds.odom, xt)
        for mode in ("batched", "ba"):
            cfg = ICMConfig(N=args.iters, L=256, cota=5.0,
                            dtype="float32", sweep_mode=mode)
            res = run(ds, cfg)
            print(json.dumps({
                "drift": drift, "mode": mode, "odom_ate": round(base, 4),
                "ate_vs_truth": round(ate(res.x, xt), 4),
                "lm_rmse": round(lm_rmse(res.map_pos, lt), 4),
                "landmarks": int(res.map_pos.shape[0]),
            }), flush=True)


if __name__ == "__main__":
    main()
