"""Shard the ICM sweep over a device mesh (run with 8 virtual CPU devices:
XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/05_...).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

if len(jax.devices()) < 2:
    # one local accelerator: demonstrate on the 8 virtual CPU devices
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from icm_slam_tpu import ICMConfig
from icm_slam_tpu.core.energy import weights
from icm_slam_tpu.data.datasets import load
from icm_slam_tpu.mapping.landmark_map import filter_map
from icm_slam_tpu.parallel.mesh import (make_mesh, replicated,
                                        shard_sweep_inputs, time_sharding)
from icm_slam_tpu.solver.icm import _filter_jit, _init_jit, prepare, seed_map
from icm_slam_tpu.solver.sweeps import refine_sweep_batched

ds = load("reference").slice(400)
cfg = ICMConfig(N=1)
data = prepare(ds, cfg)
x0 = jnp.asarray(ds.x0, data.dist.dtype)
state, x, _ = _init_jit(data, seed_map(data, x0, cfg), x0, cfg)
cur = _filter_jit(state, cfg)

mesh = make_mesh(n_devices=min(8, len(jax.devices())))
data_s, x_s, T = shard_sweep_inputs(mesh, data, x)
cur_s = jax.device_put(cur, replicated(mesh))
w = weights(cfg)


@jax.jit
def step(d, m, xx):
    st, xx = refine_sweep_batched(d, m, xx, cfg, w, last_t=T - 1)
    xx = jax.lax.with_sharding_constraint(xx, time_sharding(mesh))
    return filter_map(st, cfg.cota, cfg.dist_thr), xx

fm, x_out = step(data_s, cur_s, x_s)
jax.block_until_ready(x_out)
print(f"sharded sweep over {mesh.devices.size} devices: "
      f"{int(fm.nact)} landmarks, poses {x_out.shape}")
