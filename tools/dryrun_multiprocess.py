"""Real multi-process distributed dryrun.

Validates the multi-controller path end-to-end WITHOUT accelerators:

* N separate OS processes each call ``jax.distributed.initialize`` and
  join one coordinator (the multi-host bring-up,
  icm_slam_tpu.parallel.distributed);
* together they form ONE global 1-D time mesh over N x D virtual CPU
  devices (the analog of a multi-host GPU job; collectives ride Gloo
  here, NCCL there);
* every process builds ONLY its host-local shard of the sweep inputs
  (``jax.make_array_from_process_local_data`` via
  parallel.mesh.put_time_sharded — device_put cannot address remote
  devices);
* one full batched ICM refinement step runs jitted over the global mesh;
* each process independently re-computes the step on a single local
  device and asserts the distributed result matches.

Usage:
    python tools/dryrun_multiprocess.py [--nproc 2] [--devices-per-proc 4]
    python tools/dryrun_multiprocess.py --bench --frames 1833   # timing row

The reference has no multi-process anything (its only comm is a websocket
to rosbridge, /root/reference/scripts/ICM_SLAM.py:267-299); this is the
multi-host scaling path (BASELINE config 5).
"""
import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker (one per process)
# ---------------------------------------------------------------------------

def worker(pid: int, nproc: int, port: int, devices_per_proc: int,
           frames: int, bench_iters: int) -> None:
    # XLA_FLAGS was set by the parent BEFORE this interpreter started
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from icm_slam_tpu.parallel.distributed import initialize

    # route through the PUBLIC bring-up wrapper; alternate its two
    # configuration paths so both are exercised (even pids: explicit args;
    # odd pids: pure env-var fallbacks)
    if pid % 2 == 0:
        initialize(coordinator_address=f"localhost:{port}",
                   num_processes=nproc, process_id=pid)
    else:
        os.environ["ICM_COORDINATOR"] = f"localhost:{port}"
        os.environ["ICM_NUM_PROCESSES"] = str(nproc)
        os.environ["ICM_PROCESS_ID"] = str(pid)
        initialize()
    import time

    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    from __graft_entry__ import _tiny_problem
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.mapping.landmark_map import filter_map
    from icm_slam_tpu.parallel.mesh import (make_mesh, put_replicated,
                                            replicated, shard_sweep_inputs,
                                            time_sharding)
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    assert jax.process_count() == nproc
    assert len(jax.local_devices()) == devices_per_proc
    n_total = nproc * devices_per_proc

    # identical problem on every process (deterministic synthetic world);
    # T deliberately not a multiple of the mesh size -> exercises padding
    T = frames if frames else 4 * n_total + 3
    config, data, seed, x = _tiny_problem(T=T, obs_cap=24)
    w = weights(config)

    mesh = make_mesh(n_devices=n_total)
    data_s, x_s, true_T = shard_sweep_inputs(mesh, data, x)
    seed_s = put_replicated(mesh, seed)
    rep = replicated(mesh)

    @jax.jit
    def step(d, m, xx):
        st, xx = refine_sweep_batched(d, m, xx, config, w,
                                      last_t=true_T - 1)
        # replicate outputs so every controller can read them fully
        xx = jax.lax.with_sharding_constraint(xx, rep)
        fm = jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, rep),
            filter_map(st, config.cota, config.dist_thr))
        return fm, xx

    fm, x_out = step(data_s, seed_s, x_s)
    jax.block_until_ready((fm, x_out))
    x_dist = np.asarray(jax.device_get(x_out))[:true_T]

    # independent single-device recomputation on this process's device 0
    # (same code, no mesh) — the correctness oracle for the collective path
    @jax.jit
    def step_local(d, m, xx):
        st, xx = refine_sweep_batched(d, m, xx, config, w)
        return filter_map(st, config.cota, config.dist_thr), xx

    fm_ref, x_ref = step_local(data, seed, x)
    x_ref = np.asarray(x_ref)

    err = float(np.max(np.abs(x_dist - x_ref)))
    nact_ok = int(fm.nact) == int(fm_ref.nact)
    assert err < 1e-4, f"[{pid}] distributed != local: max err {err}"
    assert nact_ok, f"[{pid}] landmark count {int(fm.nact)} != {int(fm_ref.nact)}"

    # fleet-axis DP placement under multi-controller: put_fleet_sharded
    # must route through make_array_from_process_local_data (device_put
    # cannot address remote devices) and preserve values exactly
    from jax.sharding import NamedSharding, PartitionSpec as P

    from icm_slam_tpu.parallel.mesh import make_fleet_mesh, put_fleet_sharded
    fleet_mesh = make_fleet_mesh(n_devices=n_total)
    worlds = np.arange(2 * n_total * 16, dtype=np.float32).reshape(
        2 * n_total, 16)
    w_s = put_fleet_sharded(fleet_mesh, worlds)
    rep_f = NamedSharding(fleet_mesh, P())
    sums = np.asarray(jax.device_get(jax.jit(
        lambda a: jax.lax.with_sharding_constraint(a.sum(axis=1), rep_f)
    )(w_s)))
    np.testing.assert_allclose(sums, worlds.sum(axis=1), rtol=1e-6)

    row = {"process": pid, "processes": nproc, "devices": n_total,
           "T": true_T, "max_abs_err_vs_local": err,
           "landmarks": int(fm.nact)}
    if bench_iters:
        t0 = time.perf_counter()
        m, xx = fm, x_out  # chain outputs into inputs (honest timing)
        for _ in range(bench_iters):
            m, xx = step(data_s, m, xx)
        jax.block_until_ready(xx)
        row["refine_ms"] = round(
            (time.perf_counter() - t0) / bench_iters * 1e3, 2)
    print(f"MULTIPROCESS-WORKER {json.dumps(row)}", flush=True)


# ---------------------------------------------------------------------------
# parent (spawns the workers)
# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--frames", type=int, default=0,
                    help="0 = tiny default (4*devices+3)")
    ap.add_argument("--bench", action="store_true",
                    help="also time the distributed step")
    ap.add_argument("--bench-iters", type=int, default=5)
    ap.add_argument("--timeout", type=int, default=600)
    # internal
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()

    if args.worker >= 0:
        worker(args.worker, args.nproc, args.port, args.devices_per_proc,
               args.frames, args.bench_iters if args.bench else 0)
        return

    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{args.devices_per_proc}")
    env["JAX_PLATFORMS"] = "cpu"  # belt (workers also force it in-process)
    procs = []
    for pid in range(args.nproc):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--worker", str(pid), "--nproc", str(args.nproc),
               "--port", str(port),
               "--devices-per-proc", str(args.devices_per_proc),
               "--frames", str(args.frames),
               "--bench-iters", str(args.bench_iters)]
        if args.bench:
            cmd.append("--bench")
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
        codes.append(p.returncode)

    ok = all(c == 0 for c in codes) and \
        all("MULTIPROCESS-WORKER" in o for o in outs)
    for i, o in enumerate(outs):
        for line in o.splitlines():
            if line.startswith("MULTIPROCESS-WORKER") or not ok:
                print(f"[worker {i}] {line}")
    summary = {"ok": ok, "processes": args.nproc,
               "devices_per_proc": args.devices_per_proc,
               "exit_codes": codes}
    print(f"MULTIPROCESS {'OK' if ok else 'FAILED'} {json.dumps(summary)}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
