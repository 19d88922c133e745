"""Fleet mode: N independent SLAM worlds in ONE device program.

One world leaves the device mostly idle through the sweep's sequential
dependency chain, so W worlds finish in well under W times the latency of
one (benchmarks/fleet_curve.py measures the curve).  ``run_batched`` is
the amortization tool for multi-robot mapping, Monte-Carlo noise studies,
and parameter ensembles, all sharing one compiled pipeline (init sweep
-> map filter -> fused N-iteration refinement loop).  On a multi-device
mesh the world axis also SHARDS (data parallelism, zero collectives):
pass ``mesh=parallel.mesh.make_fleet_mesh()``.

Run: python examples/06_fleet_mode.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver.icm import run_batched

# a small Monte-Carlo study: the same world under different sensor-noise
# draws (same shapes -> one program; per-world semantics identical to
# solo run())
worlds = [synthetic_world(T=500, n_landmarks=30, world_size=30.0, seed=s)
          for s in range(4)]

results = run_batched(worlds, ICMConfig(N=10, L=256, cota=10.0,
                                        dtype="float32"))

print(f"{len(results)} worlds in one program; "
      f"pipeline {results[0].timings['pipeline_s']:.2f}s total, "
      f"{results[0].timings['per_world_s']:.2f}s/world")
for i, (ds, r) in enumerate(zip(worlds, results)):
    err = float(np.mean(np.linalg.norm(r.x[:, :2] - ds.odom[:, :2],
                                       axis=1)))
    print(f"  world {i}: {r.map_pos.shape[0]} landmarks, "
          f"mean |x - odom| = {err:.3f} m")

# the same fleet SHARDED across every available device (data parallelism
# over worlds: they never communicate, so the partitioned program has
# zero collectives; a single-device host runs the identical program on a
# 1-device mesh)
import jax

from icm_slam_tpu.parallel.mesh import make_fleet_mesh

mesh = make_fleet_mesh(jax.devices())
sharded = run_batched(worlds, ICMConfig(N=10, L=256, cota=10.0,
                                        dtype="float32"), mesh=mesh)
assert all(a.map_pos.shape == b.map_pos.shape
           for a, b in zip(sharded, results))
print(f"fleet sharded over {mesh.devices.size} device(s): same censuses, "
      f"pipeline {sharded[0].timings['pipeline_s']:.2f}s")
