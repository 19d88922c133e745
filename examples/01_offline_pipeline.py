"""Offline pipeline on the reference dataset (entry point C equivalent).

    python examples/01_offline_pipeline.py [--iters N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from icm_slam_tpu import ICMConfig
from icm_slam_tpu.api import run_offline
from icm_slam_tpu.data.datasets import load
from icm_slam_tpu.utils.metrics import ate
from icm_slam_tpu.utils.viz import plot_convergence, plot_slam

ap = argparse.ArgumentParser()
ap.add_argument("--iters", type=int, default=10)
ap.add_argument("--dataset", default="reference")
args = ap.parse_args()

ds = load(args.dataset)
cfg = ICMConfig(N=args.iters)
res = run_offline(ds, cfg, verbose=True)

print(f"{res.map_pos.shape[0]} landmarks, "
      f"{res.timings['refine_per_iter_s']*1e3:.0f} ms / ICM iteration")
print("ATE vs odometry:", ate(res.x, ds.odom))
plot_slam(res.x, res.map_pos, ds.odom, path="slam_result.png")
plot_convergence(res.changes, path="convergence.png")
print("wrote slam_result.png, convergence.png")
