"""Generate golden traces from the NumPy oracle for test/ATE validation.

Usage:
    python tools/make_golden.py [--dataset reference|/path/to.mat]
                                [--iters N] [--frames T] [--criterion C]
                                [--out PATH]

Writes an .npz with x_init (3,T), x (3,T), map (2,K), counts (K,), changes.
The default dataset is the seeded reference-shape world
(icm_slam_tpu.data.datasets.reference_world); the checked-in goldens are

    python tools/make_golden.py --frames 400 --iters 3
    python tools/make_golden.py --iters 30
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "tests", "oracle"))
sys.path.insert(0, REPO)
from reference_oracle import OracleParams, run_pipeline  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="reference",
                    help="reference | /path/to.mat")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--criterion", default="inconsistent")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from icm_slam_tpu.data.datasets import load
    ds = load(args.dataset)
    if args.frames:
        ds = ds.slice(args.frames)
    T = ds.T
    # oracle convention: column-major (B,T)/(3,T)/(2,T), raw ranges
    scans = np.ascontiguousarray(ds.scans.T)
    odom = np.ascontiguousarray(ds.odom.T)
    u = np.ascontiguousarray(ds.u.T)

    p = OracleParams(N=args.iters, cluster_criterion=args.criterion)
    t0 = time.time()
    out = run_pipeline(scans, odom, u, p)
    dt = time.time() - t0

    path = args.out or os.path.join(
        REPO, "tests", "golden",
        f"{os.path.basename(args.dataset).split('.')[0]}_T{T}_N{args.iters}"
        f"_{args.criterion}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out, wall_seconds=dt, frames=T,
                        iters=args.iters, criterion=args.criterion)
    print(f"saved {path}  ({dt:.1f}s, {T} frames x {args.iters} iters, "
          f"{out['map'].shape[1]} landmarks)")


if __name__ == "__main__":
    main()
