"""Online mode: stream frames causally, then refine (entry point A).

    python examples/02_online_streaming.py [--hz 0]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from icm_slam_tpu import ICMConfig
from icm_slam_tpu.data.datasets import load
from icm_slam_tpu.runtime.online import OnlineSLAM
from icm_slam_tpu.runtime.replay import stream_dataset

ap = argparse.ArgumentParser()
ap.add_argument("--hz", type=float, default=0.0, help="0 = full speed")
args = ap.parse_args()

ds = load("reference").slice(600)
engine = OnlineSLAM(ICMConfig(N=5), chunk_size=64, verbose=True)
for ranges, odom, u in stream_dataset(ds, hz=args.hz):
    engine.push(ranges, odom, u)
res = engine.finish(refine=True)
print(f"online run: {res.x.shape[0]} poses, {res.map_pos.shape[0]} landmarks")
