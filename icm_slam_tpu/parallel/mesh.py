"""Device-mesh sharding for the batched ICM sweep.

The parallelization axis is TIME (keyframes) — the reference's trajectory
sweep is the analog of sequence parallelism (SURVEY.md §2.3/§5).  The batched
sweep is expressed in plain jnp ops over (T, ...) arrays, so distribution is
pure GSPMD: shard the T axis of the per-frame arrays across a 1-D mesh and
let XLA insert the collectives —

  * per-frame association / LM solves: fully local per shard,
  * cumulative segment sums over T (running-mean map): associative-scan
    collectives,
  * red-black neighbour reads x[t-1], x[t+1]: halo exchange
    (collective-permute) on the sharded axis,
  * map filtering / reductions: psum into a replicated (L,2) table.

Landmark-table arrays (L, 2) stay replicated — the map is tiny (KBs).
A 1-device mesh runs the identical code path.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TIME_AXIS = "t"
FLEET_AXIS = "w"


def make_mesh(devices=None, n_devices=None) -> Mesh:
    """1-D mesh over the time axis (first ``n_devices`` of ``devices``).

    Devices are ordered by (process_index, id) so that in a multi-process
    job each process owns one CONTIGUOUS block of the time axis — the
    layout `shard_sweep_inputs` builds its process-local shards against.
    """
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (TIME_AXIS,))


def make_fleet_mesh(devices=None, n_devices=None) -> Mesh:
    """1-D mesh over the FLEET (world) axis — data parallelism for
    run_batched: worlds never exchange information, so sharding the vmapped
    world axis partitions the whole pipeline with ZERO collectives (each
    device runs its worlds' init + refine loop end-to-end locally).
    Orthogonal to make_mesh's time sharding (the SP analog)."""
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (FLEET_AXIS,))


def fleet_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (world) sharding on a fleet mesh."""
    return NamedSharding(mesh, P(FLEET_AXIS))


def put_fleet_sharded(mesh: Mesh, tree):
    """Place a stacked (W, ...) pytree on the mesh, worlds sharded across
    devices (leading axis); W must be divisible by the mesh size (callers
    pad by replicating a world — see solver.icm.run_batched).

    Multi-controller: plain device_put cannot address non-addressable
    devices, so each process hands its contiguous block of worlds to
    ``jax.make_array_from_process_local_data`` (every process holds the
    full stacked tree; W divisible by the mesh size implies divisible by
    the process count, since processes own equal device blocks).
    """
    fs = fleet_sharding(mesh)
    nproc = jax.process_count()
    if nproc == 1:
        return jax.tree.map(lambda a: jax.device_put(a, fs), tree)
    pid = jax.process_index()

    def put(a):
        a = np.asarray(a)
        per = a.shape[0] // nproc
        local = np.ascontiguousarray(a[pid * per:(pid + 1) * per])
        return jax.make_array_from_process_local_data(fs, local, a.shape)

    return jax.tree.map(put, tree)


def time_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(TIME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_time_sharded(mesh: Mesh, a):
    """Place one (T, ...) array on the mesh, sharded along the time axis.

    Single-controller: plain device_put.  Multi-process: each process
    builds ONLY its own contiguous block of rows and hands it to
    ``jax.make_array_from_process_local_data`` — device_put cannot address
    remote devices, so this is the only correct multi-controller path.
    Requires T divisible by the process count (shard_sweep_inputs pads to
    the mesh size, which every process count divides).
    """
    ts = time_sharding(mesh)
    nproc = jax.process_count()
    if nproc == 1:
        return jax.device_put(a, ts)
    per = a.shape[0] // nproc
    pid = jax.process_index()
    local = np.ascontiguousarray(a[pid * per:(pid + 1) * per])
    return jax.make_array_from_process_local_data(ts, local, a.shape)


def put_replicated(mesh: Mesh, tree):
    """Replicate a pytree onto every device of the mesh (multi-process
    safe: every process must pass identical values)."""
    rep = replicated(mesh)
    if jax.process_count() == 1:
        return jax.device_put(tree, rep)

    def put(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, rep, lambda idx: a[idx])

    return jax.tree.map(put, tree)


def shard_sweep_inputs(mesh: Mesh, data, x, pad_to=None):
    """Place SweepData + poses on the mesh: T-axis sharded, rest replicated.

    Pads T up to a multiple of the mesh size if needed (padded frames are
    all-masked -> empty frames, which the sweep treats as dead-reckoning;
    callers slice the poses back).  Works single- and multi-controller
    (see put_time_sharded).
    """
    from icm_slam_tpu.solver.sweeps import SweepData
    import jax.numpy as jnp

    n = mesh.devices.size
    T = data.dist.shape[0]
    pad = (-T) % (pad_to or n)
    if pad:
        def pad_t(a, value=0.0):
            cfgw = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, cfgw, constant_values=value)

        data = SweepData(
            dist=pad_t(data.dist), mask=pad_t(data.mask, False),
            # a shared 1-D beam-angle vector is T-independent; a
            # pre-compacted per-frame (T, B) ang must be padded like every
            # other per-frame array (and the padded rows are all-masked,
            # so zero angles are never read)
            ang=(data.ang if data.ang.ndim == 1 else pad_t(data.ang)),
            odom=pad_t(data.odom), u=pad_t(data.u))
        x = jnp.pad(x, [(0, pad), (0, 0)])

    data = SweepData(
        dist=put_time_sharded(mesh, data.dist),
        mask=put_time_sharded(mesh, data.mask),
        ang=(put_replicated(mesh, data.ang) if data.ang.ndim == 1
             else put_time_sharded(mesh, data.ang)),
        odom=put_time_sharded(mesh, data.odom),
        u=put_time_sharded(mesh, data.u))
    x = put_time_sharded(mesh, x)
    return data, x, T


def time_sharded_refine_step(mesh: Mesh, config, true_T: int):
    """One jitted batched refine sweep + map filter on ``mesh``: poses
    sharded along time, the filtered map replicated.  ``true_T`` is the
    trajectory's real length (``shard_sweep_inputs`` pads T)."""
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.mapping.landmark_map import filter_map
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    ts, rep = time_sharding(mesh), replicated(mesh)
    w = weights(config)

    @jax.jit
    def step(data, old_map, x):
        state, x = refine_sweep_batched(data, old_map, x, config, w,
                                        last_t=true_T - 1)
        x = jax.lax.with_sharding_constraint(x, ts)
        fm = filter_map(state, config.cota, config.dist_thr)
        fm = jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, rep), fm)
        return fm, x

    return step


def sharded_vs_one_device(devices, n_devices: int, config, data, old_map, x):
    """One refine step time-sharded over ``n_devices`` and the SAME padded
    step on a 1-device mesh.  Returns ``((map, poses), (map, poses))`` —
    sharded first — with the poses cut back to the real T, as numpy."""
    out = []
    for n in (n_devices, 1):
        mesh = make_mesh(devices, n)
        data_s, x_s, true_T = shard_sweep_inputs(mesh, data, x,
                                                 pad_to=n_devices)
        map_s = jax.device_put(old_map, replicated(mesh))
        fm, x_out = time_sharded_refine_step(mesh, config, true_T)(
            data_s, map_s, x_s)
        out.append((jax.tree.map(np.asarray, fm),
                    np.asarray(x_out)[:true_T]))
    return out[0], out[1]
