"""Smoke run of the offline ICM pipeline on the GPU, checked against references.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: only the sharded paths

One GPU: ``solver.icm.run`` (the path behind ``python -m icm_slam_tpu run``
and ``api.run_offline``) at full width on the seeded reference-shape world
(data.datasets.REFERENCE_WORLD, configs/reference.yaml physics) at the max
and the default profile; the same program on the CPU and the NumPy oracle
as references; the refine loop at default and highest matmul precision; an
8-world fleet; one profiled refine call.  ``--four``: the 8-world fleet
sharded over four GPUs against one GPU, and one full-width world
time-sharded over four GPUs against one.

Exits non-zero, printing no result, when JAX finds no GPU.  The last line
of stdout is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PROFILES = {"max": dict(pose_passes=1, pose_gn_iters=1),
            "default": dict(pose_passes=2, pose_gn_iters=8)}
FLEET_WORLDS = 8
# the NumPy oracle's trace of REFERENCE_WORLD at N=30 (tools/make_golden.py)
GOLDEN_FULL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden",
                           "reference_T1833_N30_inconsistent.npz")
ORACLE_FRAMES, ORACLE_ITERS = 400, 3
# tests/test_e2e.py's ATE_TOL, and a tenth of it for GPU against CPU
ORACLE_ATE_TOL = 0.10
CPU_DEV_TOL = 0.01
# mean position deviation between two GPU programs of one world (fleet
# against solo, sharded against one card): tests/test_fleet_sharded.py's
# 1e-3.  Each program orders its f32 reductions its own way on the GPU.
# The label_flips line shows whether any beam then associates differently
# and where the largest deviation lies.
FLEET_TOL = 1e-3
# their largest pose deviation, over the 1.915e-3 m (one card) and
# 4.8e-3 m (four cards) measured on an H100
FLEET_MAX_TOL = 5e-3
FOUR_FLEET_MAX_TOL = 1e-2
# __graft_entry__.dryrun_multichip's bound on every pose of one
# time-sharded refine step
FOUR_TIME_TOL = 5e-4


def log(*args):
    print(*args, flush=True)


def pos_dev(a, b):
    """(mean, max) planar distance between two (T, 3) trajectories."""
    d = np.linalg.norm(np.asarray(a)[:, :2] - np.asarray(b)[:, :2], axis=1)
    return float(d.mean()), float(d.max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_lines(devices):
    return [f"{d} platform={d.platform} device_kind={d.device_kind}"
            for d in devices]


def refine_inputs(ds, cfg):
    """prepare -> resolve -> seed -> init -> filter -> compaction hoist on
    the default device, as run() does: the fused refine loop's arguments
    ``(data, map, poses, resolved config)``."""
    import jax.numpy as jnp
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit,
                                         hoist_compaction, prepare,
                                         resolve_config, seed_map)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    state, x, _ = _init_jit(data, seed_map(data, x0, cfg), x0, cfg)
    return hoist_compaction(data, cfg), _filter_jit(state, cfg), x, cfg


def main_path(device, ds, truth, cfg, label, golden=None):
    """Phase 2: run() on ``device``, first (compiling) and warm call; with
    ``golden`` (the NumPy oracle's trace of ``ds`` at ``cfg.N``), ATE under
    ORACLE_ATE_TOL and the oracle's census."""
    import jax
    from icm_slam_tpu.solver.icm import _refine_loop_jit, run
    with jax.default_device(device):
        t0 = time.perf_counter()
        first = run(ds, cfg)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run(ds, cfg)
        warm_s = time.perf_counter() - t0
        data, cur_map, x, rcfg = refine_inputs(ds, cfg)
        mem = _refine_loop_jit.lower(data, cur_map, x, rcfg,
                                     rcfg.N).compile().memory_analysis()
    check(np.isfinite(res.x).all(), f"{label}: non-finite poses")
    check(res.x.shape == (ds.T, 3), f"{label}: poses {res.x.shape}")
    check(first.map_pos.shape == res.map_pos.shape,
          f"{label}: first and warm call censuses differ")
    rerun = pos_dev(first.x, res.x)
    stats = device.memory_stats() or {}
    ate = pos_dev(res.x, truth)
    log(f"[main {label}] first call {first_s:.3f} s (compiles), warm call "
        f"{warm_s:.3f} s")
    log(f"[main {label}] timings first {first.timings}")
    log(f"[main {label}] timings warm {res.timings}")
    log(f"[main {label}] _refine_loop_jit memory_analysis: "
        + ", ".join(f"{k}={getattr(mem, k, None)}" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")))
    log(f"[main {label}] peak_bytes_in_use="
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    log(f"[main {label}] census {res.map_pos.shape[0]}, ATE vs ground "
        f"truth mean {ate[0]:.4f} m max {ate[1]:.4f} m")
    log(f"[main {label}] first against warm call: position deviation mean "
        f"{rerun[0]:.3e} m max {rerun[1]:.3e} m")
    if golden is not None:
        ate_o = pos_dev(res.x, golden["x"].T)
        log(f"[main {label}] against the NumPy oracle (tests/golden, N="
            f"{cfg.N}): ATE mean {ate_o[0]:.4f} m max {ate_o[1]:.4f} m, "
            f"census {res.map_pos.shape[0]} oracle {golden['map'].shape[1]}")
        check(ate_o[0] < ORACLE_ATE_TOL, f"{label}: ATE {ate_o[0]} vs oracle")
        check(res.map_pos.shape[0] == golden["map"].shape[1],
              f"{label}: census differs from the oracle")
    return res


def cpu_check(dev_res, ds, cfg, cpu, label):
    """Phase 3a: the same program on the CPU: equal census, mean position
    deviation under CPU_DEV_TOL."""
    import jax
    from icm_slam_tpu.solver.icm import run
    with jax.default_device(cpu):
        ref = run(ds, cfg)
    mean, mx = pos_dev(dev_res.x, ref.x)
    log(f"[cpu-check {label}] census device {dev_res.map_pos.shape[0]} cpu "
        f"{ref.map_pos.shape[0]}; position deviation mean {mean:.3e} m "
        f"max {mx:.3e} m")
    check(dev_res.map_pos.shape == ref.map_pos.shape,
          f"{label}: census differs from the CPU run")
    check(mean < CPU_DEV_TOL, f"{label}: mean deviation {mean} m from CPU")
    return mean, mx


def oracle_check(device, ds, cfg):
    """Phase 3b: the NumPy oracle on ``ds``: ATE under ORACLE_ATE_TOL for
    the init and the refined poses, and the exact census."""
    import jax
    from icm_slam_tpu.solver.icm import run
    from tests.oracle.reference_oracle import OracleParams, run_pipeline
    golden = run_pipeline(np.ascontiguousarray(ds.scans.T),
                          np.ascontiguousarray(ds.odom.T),
                          np.ascontiguousarray(ds.u.T),
                          OracleParams(N=cfg.N), verbose=False)
    with jax.default_device(device):
        res = run(ds, cfg)
    ate_init = pos_dev(res.x_init, golden["x_init"].T)[0]
    ate = pos_dev(res.x, golden["x"].T)[0]
    log(f"[oracle-check T={ds.T} N={cfg.N}] ATE init {ate_init:.4f} m, "
        f"refined {ate:.4f} m; census {res.map_pos.shape[0]} oracle "
        f"{golden['map'].shape[1]}")
    check(ate_init < ORACLE_ATE_TOL and ate < ORACLE_ATE_TOL,
          f"ATE vs oracle {ate_init}, {ate}")
    check(res.map_pos.shape[0] == golden["map"].shape[1],
          "census differs from the oracle")
    return ate


def precision_check(device, cpu, ds, cfg):
    """Phase 4: the refine loop from one init state at default and at
    highest matmul precision, each against the CPU."""
    import jax
    from icm_slam_tpu.solver.icm import _refine_loop_jit
    with jax.default_device(device):
        args = refine_inputs(ds, cfg)
        outs = {}
        for prec in ("default", "highest"):
            ctx = (jax.default_matmul_precision(prec) if prec == "highest"
                   else contextlib.nullcontext())
            with ctx:
                m, x, _, _ = _refine_loop_jit(*args, args[3].N)
            outs[prec] = (int(m.nact), np.asarray(x))
    with jax.default_device(cpu):
        m_c, x_c, _, _ = _refine_loop_jit(*jax.device_put(args[:3], cpu),
                                          args[3], args[3].N)
    x_c = np.asarray(x_c)
    for prec, (nact, x) in outs.items():
        check(np.isfinite(x).all(), f"non-finite poses at {prec}")
        mean, mx = pos_dev(x, x_c)
        log(f"[precision {prec}] census {nact} (cpu {int(m_c.nact)}); "
            f"deviation from cpu mean {mean:.3e} m max {mx:.3e} m")
    mean, mx = pos_dev(outs["default"][1], outs["highest"][1])
    log(f"[precision] default vs highest: mean {mean:.3e} m max {mx:.3e} m")
    return outs


def beam_labels(ds, cfg, x, map_pos):
    """Each informative beam's landmark at poses ``x`` against ``map_pos``:
    the nearest one within dist_thr, else -1; and its distance."""
    from icm_slam_tpu.solver.icm import prepare
    data = prepare(ds, cfg)
    dist, ang = (np.asarray(v, np.float64) for v in (data.dist, data.ang))
    mask = np.asarray(data.mask, bool)
    x = np.asarray(x, np.float64)
    a = ang + x[:, 2:3] - np.pi / 2
    px = x[:, :1] + dist * np.cos(a)
    py = x[:, 1:2] + dist * np.sin(a)
    m = np.asarray(map_pos, np.float64).reshape(-1, 2)
    if not len(m):
        return np.full(dist.shape, -1), np.full(dist.shape, np.inf)
    d = np.hypot(px[..., None] - m[:, 0], py[..., None] - m[:, 1])
    lab, dmin = d.argmin(-1), d.min(-1)
    return np.where(mask & (dmin <= cfg.dist_thr), lab, -1), dmin


def label_flips(ds, cfg, a, b):
    """Two runs of one world (ICMResults of equal census): the beams they
    associate differently at their final poses and maps, how many of those
    lie within 1 cm of the dist_thr gate in either run, the frame of the
    largest pose deviation and the landmark-labelled beams there."""
    la, da = beam_labels(ds, cfg, a.x, a.map_pos)
    lb, db = beam_labels(ds, cfg, b.x, b.map_pos)
    # b's landmarks by their nearest in a, in case the tables are ordered
    # differently
    ma, mb = np.asarray(a.map_pos), np.asarray(b.map_pos)
    if len(ma) and len(mb):
        near = np.linalg.norm(mb[:, None] - ma[None], axis=-1).argmin(1)
        lb = np.where(lb >= 0, near[np.maximum(lb, 0)], -1)
    flips = la != lb
    gate = (np.abs(da - cfg.dist_thr) < 0.01) | (np.abs(db - cfg.dist_thr)
                                                 < 0.01)
    worst = int(np.abs(np.asarray(a.x) - np.asarray(b.x)).max(1).argmax())
    return (int(flips.sum()), int((flips & gate).sum()), worst,
            int((la[worst] >= 0).sum()))


def fleet_check(device, worlds, cfg):
    """Phase 5: run_batched over distinct worlds; world 0 against its solo
    run() under the fleet's merged config (tests/test_fleet.py)."""
    import jax
    from icm_slam_tpu.solver.icm import (prepare, resolve_fleet_config, run,
                                         run_batched)
    with jax.default_device(device):
        t0 = time.perf_counter()
        fleet = run_batched(worlds, cfg)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = run_batched(worlds, cfg)
        warm_s = time.perf_counter() - t0
        merged = resolve_fleet_config(cfg, [prepare(w, cfg) for w in worlds])
        solo = run(worlds[0], merged)
    mean, mx = pos_dev(fleet[0].x, solo.x)
    init = pos_dev(fleet[0].x_init, solo.x_init)
    log(f"[fleet W={len(worlds)}] first call {first_s:.3f} s, warm "
        f"{warm_s:.3f} s, timings {fleet[0].timings}")
    log(f"[fleet] censuses {[r.map_pos.shape[0] for r in fleet]}; world 0 "
        f"vs solo: census {solo.map_pos.shape[0]}, position deviation mean "
        f"{mean:.3e} m max {mx:.3e} m (init: mean {init[0]:.3e} m max "
        f"{init[1]:.3e} m), max abs pose deviation "
        f"{float(np.abs(fleet[0].x - solo.x).max()):.3e}")
    check(all(np.isfinite(r.x).all() for r in fleet), "non-finite fleet")
    check(fleet[0].map_pos.shape == solo.map_pos.shape,
          "fleet world 0 census differs from its solo run")
    flips, at_gate, worst, seen = label_flips(worlds[0], merged, fleet[0],
                                              solo)
    log(f"[fleet] world 0 vs solo: {flips} beams labelled differently, "
        f"{at_gate} of them within 1 cm of the gate; largest pose "
        f"deviation at frame {worst} of {worlds[0].T}, which has {seen} "
        f"landmark-labelled beams")
    check(mean < FLEET_TOL, f"fleet world 0 deviates {mean} m from solo")
    check(mx < FLEET_MAX_TOL, f"fleet world 0 deviates up to {mx} m")
    return fleet


def hlo_op_names(hlo_text):
    """HLO instruction name -> metadata op_name (jax.named_scope path)."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'metadata=\{[^}]*op_name="([^"]*)"', re.M)
    return dict(pat.findall(hlo_text))


def device_op_times(trace_dir, platform):
    """Summed duration (ns) per XLA op from a jax.profiler trace: the GPU's
    device planes, or the host's XLA op events for a CPU device."""
    import jax
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    prefix = "/device:GPU" if platform == "gpu" else "/host:CPU"
    times = {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith(prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if platform != "gpu" and "hlo_op" not in stats:
                    continue
                op = stats.get("hlo_op") or ev.name
                times[op] = times.get(op, 0.0) + ev.duration_ns
    return times


def profile_once(fn, args, trace_dir, platform):
    """Per-op device time of one call of ``fn(*args)`` after a warm-up,
    and the call's wall time in seconds."""
    import jax
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        wall = time.perf_counter() - t0
    return device_op_times(trace_dir, platform), wall


def trace_check(device, ds, cfg, trace_dir):
    """Phase 6: one fused refine call under jax.profiler: the ten longest
    device ops and the association block's share of device op time.

    A GPU runs the loop as CUDA-graph command buffers, which the trace
    shows as one op, so the per-op breakdown comes from a second compile
    with command buffers off; both totals are printed."""
    import jax
    from icm_slam_tpu.solver.icm import _refine_loop_jit
    with jax.default_device(device):
        args = refine_inputs(ds, cfg)
        lowered = _refine_loop_jit.lower(*args, args[3].N)
        graphs = lowered.compile()
        ops = lowered.compile(
            compiler_options={"xla_gpu_enable_command_buffer": ""})
        t_graphs, wall_graphs = profile_once(
            graphs, args[:3], os.path.join(trace_dir, "graphs"),
            device.platform)
        times, wall = profile_once(ops, args[:3],
                                   os.path.join(trace_dir, "ops"),
                                   device.platform)
    names = hlo_op_names(ops.as_text())
    total = sum(times.values())
    check(total > 0, "no device op in the trace")
    log(f"[trace] as run(): {sum(t_graphs.values()) / 1e6:.3f} ms device "
        f"op time, {1e3 * wall_graphs:.3f} ms wall, {args[3].N} sweeps")
    log(f"[trace] command buffers off: {len(times)} device ops, "
        f"{total / 1e6:.3f} ms device op time, {1e3 * wall:.3f} ms wall")
    for op, ns in sorted(times.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[trace]   {ns / 1e6:9.3f} ms {100 * ns / total:5.1f}%  {op}  "
            f"{names.get(op, '?')}")
    shares = {}
    for scope in ("association", "pose_solve", "filter_map"):
        ns = sum(t for op, t in times.items()
                 if f"/{scope}/" in names.get(op, ""))
        shares[scope] = ns / total
    unnamed = sum(t for op, t in times.items() if op not in names) / total
    log(f"[trace] share of device op time: "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items())
        + f"; ops not found in the HLO {100 * unnamed:.1f}%")
    return shares


def run_phase(failures, name, fn, *args):
    """Run one phase; a failure is printed and recorded, and the later
    phases still run (main() then exits non-zero without a result)."""
    try:
        return fn(*args)
    except Exception:
        failures.append(name)
        log(f"[FAILED {name}]\n{traceback.format_exc()}")
        return None


def one_card(gpu, cpu):
    """The one-GPU phases; returns the names of the phases that failed."""
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import REFERENCE_WORLD, reference_world
    ds, truth, _ = reference_world(return_truth=True)
    log(f"[world] {ds.name} T={ds.T} beams={ds.n_beams} {REFERENCE_WORLD}")
    golden = np.load(GOLDEN_FULL)
    failures = []
    # ICMConfig's defaults are configs/reference.yaml's physics
    for label, prof in PROFILES.items():
        res = run_phase(failures, f"main {label}", main_path, gpu, ds, truth,
                        ICMConfig(**prof), label, golden)
        if res is not None:
            run_phase(failures, f"cpu-check {label}", cpu_check, res, ds,
                      ICMConfig(**prof), cpu, label)
    run_phase(failures, "oracle-check", oracle_check, gpu,
              ds.slice(ORACLE_FRAMES), ICMConfig(N=ORACLE_ITERS))
    run_phase(failures, "precision", precision_check, gpu, cpu, ds,
              ICMConfig(**PROFILES["default"]))
    seed0 = REFERENCE_WORLD["seed"]
    worlds = [reference_world(seed=seed0 + k) for k in range(FLEET_WORLDS)]
    run_phase(failures, "fleet", fleet_check, gpu, worlds,
              ICMConfig(**PROFILES["max"]))
    with tempfile.TemporaryDirectory() as tdir:
        run_phase(failures, "trace", trace_check, gpu, ds,
                  ICMConfig(**PROFILES["max"]), tdir)
    return failures


def four_cards(gpus):
    """Fleet and time-axis sharding over four GPUs against one GPU."""
    import jax
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import REFERENCE_WORLD, reference_world
    from icm_slam_tpu.parallel.mesh import (make_fleet_mesh,
                                            sharded_vs_one_device)
    from icm_slam_tpu.solver.icm import run_batched
    cfg = ICMConfig(**PROFILES["max"])
    seed0 = REFERENCE_WORLD["seed"]
    worlds = [reference_world(seed=seed0 + k) for k in range(FLEET_WORLDS)]
    timed = {}
    for cards in (1, 4):
        for call in ("first", "warm"):
            with jax.default_device(gpus[0]):
                t0 = time.perf_counter()
                out = run_batched(worlds, cfg, mesh=(
                    make_fleet_mesh(gpus, 4) if cards == 4 else None))
                timed[cards, call] = time.perf_counter() - t0
        if cards == 1:
            one = out
    four = out
    devs = [pos_dev(a.x, b.x) for a, b in zip(four, one)]
    w = int(np.argmax([d[1] for d in devs]))
    log(f"[four fleet W={FLEET_WORLDS}] run_batched seconds, first/warm "
        f"call: one card {timed[1, 'first']:.3f}/{timed[1, 'warm']:.3f}, "
        f"four cards {timed[4, 'first']:.3f}/{timed[4, 'warm']:.3f}; censuses "
        f"{[r.map_pos.shape[0] for r in four]} vs "
        f"{[r.map_pos.shape[0] for r in one]}; position deviation per "
        f"world mean/max {[f'{a:.1e}/{b:.1e}' for a, b in devs]} m")
    check(all(a.map_pos.shape == b.map_pos.shape for a, b in zip(four, one)),
          "sharded fleet census differs")
    flips, at_gate, frame, seen = label_flips(worlds[w], cfg, four[w],
                                              one[w])
    log(f"[four fleet] world {w} (largest deviation): {flips} beams "
        f"labelled differently, {at_gate} of them within 1 cm of the gate; "
        f"largest pose deviation at frame {frame}, which has {seen} "
        f"landmark-labelled beams")
    check(max(d[0] for d in devs) < FLEET_TOL, "sharded fleet deviates")
    check(devs[w][1] < FOUR_FLEET_MAX_TOL,
          f"sharded fleet deviates up to {devs[w][1]} m")

    ds = worlds[0]
    with jax.default_device(gpus[0]):
        data, cur_map, x, rcfg = refine_inputs(ds, cfg)
    (fm, xs), (fm1, x1) = sharded_vs_one_device(gpus, 4, rcfg, data,
                                                cur_map, x)
    k = int(fm1.nact)
    per_frame = np.abs(xs - x1).max(axis=1)
    over = np.flatnonzero(per_frame > FOUR_TIME_TOL)
    # first frame of shards 1..3 after padding T to a multiple of 4
    shard = -(-ds.T // 4)
    bounds = [shard * i for i in (1, 2, 3)]
    mdev = float(np.abs(fm.pos[:k] - fm1.pos[:k]).max()) if k else 0.0
    log(f"[four time-shard T={ds.T}] census {int(fm.nact)} vs {k}; max "
        f"deviation: position {np.abs(xs - x1)[:, :2].max():.3e} m, heading "
        f"{np.abs(xs - x1)[:, 2].max():.3e} rad, map {mdev:.3e} m; "
        f"{len(over)} of {ds.T} poses beyond {FOUR_TIME_TOL}: frames "
        f"{over.tolist()[:20]}, deviation "
        f"{[f'{v:.3e}' for v in per_frame[over][:20]]}; shard boundaries "
        f"{bounds}")
    check(int(fm.nact) == k, "time-sharded census differs")
    check(mdev <= FOUR_TIME_TOL, f"time-sharded map deviates {mdev} m")
    check(not len(over),
          f"{len(over)} time-sharded poses deviate beyond {FOUR_TIME_TOL}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)

    import jax
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    need = 4 if args.four else 1
    if len(gpus) < need:
        print(f"chip_smoke: needs {need} GPU(s), JAX sees {jax.devices()}",
              file=sys.stderr)
        return 2
    import icm_slam_tpu  # noqa: F401  (fails before any output without it)
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    for line in device_lines(jax.devices()):
        log(f"[device] {line}")
    log(f"[device] JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '(unset)')}")
    if args.four:
        four_cards(gpus[:4])
    else:
        failures = one_card(gpus[0], jax.devices("cpu")[0])
        if failures:
            print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
            return 1
    dev = jax.devices()[0]
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
