"""Command-line interface.

    python -m icm_slam_tpu run --dataset reference --config <yaml> [...]
    python -m icm_slam_tpu replay --dataset reference --hz 10 [...]
    python -m icm_slam_tpu online --host localhost --port 9090 [...]
    python -m icm_slam_tpu bench [...]

``run`` is the offline pipeline (reference entry point C / __main__);
``replay`` feeds frames through the online engine at a fixed rate (reference
entry points A+D: createbag.py publisher + online init); ``online`` is the
live workflow — capture from a real rosbridge, then refine (reference entry
points A+B: ICM_ROS.py:280-316 / example.py; needs roslibpy).
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_common(ap):
    ap.add_argument("--dataset", default="reference",
                    help="reference (seeded reference-shape world) | "
                         "synthetic | /path/to.mat")
    ap.add_argument("--config", default=None, help="reference-format YAML")
    ap.add_argument("--iters", type=int, default=None, help="override N")
    ap.add_argument("--frames", type=int, default=0, help="truncate frames")
    ap.add_argument("--mode", default=None,
                    choices=["sequential", "batched", "ba", "windowed_ba"],
                    help="sweep mode")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--out", default=None, help="write result .npz here")
    ap.add_argument("--log", default=None, help="JSON-lines metrics path")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--plot", default=None, metavar="DIR",
                    help="save trajectory/convergence PNGs to DIR")
    ap.add_argument("--profile",
                    choices=["fast", "default", "turbo", "ultra", "max"],
                    default=None,
                    help="knob preset (pose_passes x pose_gn_iters): "
                         "default = 2 x 8, fast = 1 x 6, turbo = 1 x 3, "
                         "ultra = 1 x 2, max = 1 x 1.  The 1-pass presets "
                         "can reach DIFFERENT ICM fixed points on hard "
                         "worlds (benchmarks/ood_fuzz.py) — per-deployment "
                         "dials, not defaults")
    ap.add_argument("--jacobi", action="store_true",
                    help="pose_update=jacobi: full Jacobi passes instead "
                         "of red-black half-pass pairs (half the "
                         "sequential LM depth; quality-gated in-suite)")
    ap.add_argument("--map-cap", type=int, default=None, metavar="K",
                    help="map_run_cap override; with --checked-cap the cap "
                         "is kept under a runtime witness (exact-or-error) "
                         "even when the cota bound cannot prove it")
    ap.add_argument("--checked-cap", action="store_true",
                    help="verify map_run_cap at runtime instead of the "
                         "provable total_obs/cota bound")
    ap.add_argument("--plot-live", action="store_true",
                    help="re-plot trajectory + map after every ICM "
                         "iteration (reference per-iteration plotting)")
    ap.add_argument("--loop-close", action="store_true",
                    help="detect loop closures (scan ICP) and pose-graph "
                         "correct the refined trajectory")
    ap.add_argument("--export-map", default=None, metavar="PGM",
                    help="write the landmark map as an occupancy-grid PGM")
    ap.add_argument("--export-tum", default=None, metavar="TXT",
                    help="write the trajectory in TUM format")


def _config(args):
    """ICMConfig from --config YAML (reference format) + flag overrides.

    Tolerates commands that expose only a subset of the common flags
    (the ``online`` command has no dataset/cap knobs)."""
    from icm_slam_tpu.config import ICMConfig

    overrides = {}
    if getattr(args, "iters", None) is not None:
        overrides["N"] = args.iters
    if getattr(args, "mode", None):
        overrides["sweep_mode"] = args.mode
    if getattr(args, "map_cap", None) is not None:
        overrides["map_run_cap"] = args.map_cap
    if getattr(args, "checked_cap", False):
        overrides["map_run_cap_checked"] = True
    if getattr(args, "profile", None):
        p, g = {"fast": (1, 6), "default": (2, 8), "turbo": (1, 3),
                "ultra": (1, 2), "max": (1, 1)}[args.profile]
        overrides.setdefault("pose_passes", p)
        overrides.setdefault("pose_gn_iters", g)
    if getattr(args, "jacobi", False):
        overrides.setdefault("pose_update", "jacobi")
    return (ICMConfig.from_yaml(args.config, **overrides) if args.config
            else ICMConfig(**overrides))


def _build(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from icm_slam_tpu.data.datasets import load

    cfg = _config(args)
    ds = load(args.dataset)
    if args.frames:
        ds = ds.slice(args.frames)
    return ds, cfg


def _save(args, res, ds):
    """``ds`` may be None (live ``online`` capture has no Dataset)."""
    import numpy as np
    if args.out:
        np.savez_compressed(args.out, x=res.x, x_init=res.x_init,
                            map_pos=res.map_pos, map_counts=res.map_counts,
                            changes=res.changes)
    if args.plot:
        import os
        from icm_slam_tpu.utils.viz import plot_convergence, plot_slam
        os.makedirs(args.plot, exist_ok=True)
        name = ds.name if ds is not None else "online"
        plot_slam(res.x, res.map_pos,
                  odom=ds.odom if ds is not None else None,
                  path=os.path.join(args.plot, "slam.png"),
                  title=f"{name}: trajectory + {res.map_pos.shape[0]} landmarks")
        plot_convergence(res.changes,
                         path=os.path.join(args.plot, "convergence.png"))
    if not args.quiet:
        from icm_slam_tpu.utils.metrics import ate
        summary = {
            "frames": int(res.x.shape[0]),
            "landmarks": int(res.map_pos.shape[0]),
            "timings": {k: round(v, 4) for k, v in res.timings.items()},
        }
        if ds is not None:
            summary["ate_vs_odom"] = ate(res.x, ds.odom)
        print(json.dumps(summary))


def cmd_run(args):
    ds, cfg = _build(args)
    from icm_slam_tpu.api import run_offline
    res = run_offline(ds, cfg, checkpoint_dir=args.checkpoint_dir,
                      resume=args.resume, log_path=args.log,
                      verbose=not args.quiet,
                      live_plot=True if args.plot_live else None)
    if args.loop_close:
        import jax.numpy as jnp
        import numpy as np
        from icm_slam_tpu.models.loop_closure import close_loops
        from icm_slam_tpu.solver.icm import prepare
        data = prepare(ds, cfg)
        x_fix, cl = close_loops(data, jnp.asarray(res.x, data.dist.dtype),
                                cfg)
        res.x = np.asarray(x_fix)
        if not args.quiet:
            print(f"# loop closures accepted: {cl.pairs.shape[0]}")
    if args.export_map:
        from icm_slam_tpu.utils.export import save_map_pgm
        save_map_pgm(args.export_map, res.map_pos, trajectory=res.x)
    if args.export_tum:
        from icm_slam_tpu.utils.export import save_trajectory_tum
        save_trajectory_tum(args.export_tum, res.x, deltat=cfg.deltat)
    _save(args, res, ds)


def cmd_replay(args):
    ds, cfg = _build(args)
    from icm_slam_tpu.api import run_online
    from icm_slam_tpu.runtime.replay import stream_dataset
    res = run_online(stream_dataset(ds, hz=args.hz), cfg,
                     refine=not args.no_refine, verbose=not args.quiet)
    _save(args, res, ds)


def cmd_online(args):
    """The reference's primary live workflow (ICM_ROS.py:280-316 /
    example.py): connect to a rosbridge, run the causal init over the
    incoming frames for the capture window (``config.time``, or until the
    /icm_slam/iterative_flag SetBool service fires and the buffer drains),
    then refine offline and write the outputs."""
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    cfg = _config(args)
    from icm_slam_tpu.api import run_online
    from icm_slam_tpu.runtime.ingest import RosBridgeSource

    src = RosBridgeSource(cfg, host=args.host, port=args.port)
    src.connect()
    try:
        dur = args.duration if args.duration is not None else cfg.time
        res = run_online(src.frames(duration=dur), cfg,
                         refine=not args.no_refine, verbose=not args.quiet)
    finally:
        src.disconnect()
    if args.export_map:
        from icm_slam_tpu.utils.export import save_map_pgm
        save_map_pgm(args.export_map, res.map_pos, trajectory=res.x)
    if args.export_tum:
        from icm_slam_tpu.utils.export import save_trajectory_tum
        save_trajectory_tum(args.export_tum, res.x, deltat=cfg.deltat)
    if not args.quiet:
        print(json.dumps({"sync": src.sync.stats}))
    _save(args, res, None)


def cmd_bench(args):
    """Run the headline benchmark.

    Works both from a source checkout (bench.py at the repo root) and from
    an installed package (falls back to the bundled benchmark module).
    """
    import os
    import subprocess
    bench = os.path.normpath(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "..", "bench.py"))
    if os.path.exists(bench):
        cmd = [sys.executable, bench] + args.rest
    else:
        cmd = [sys.executable, "-m", "icm_slam_tpu.benchmarks.headline"] \
            + args.rest
    raise SystemExit(subprocess.call(cmd))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="icm_slam_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="offline pipeline on a dataset")
    _add_common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_rep = sub.add_parser("replay", help="stream frames through the online engine")
    _add_common(p_rep)
    p_rep.add_argument("--hz", type=float, default=0.0,
                       help="replay rate (0 = as fast as possible)")
    p_rep.add_argument("--no-refine", action="store_true")
    p_rep.set_defaults(fn=cmd_replay)

    p_on = sub.add_parser(
        "online", help="live capture from a rosbridge, then refine "
                       "(the reference's example.py workflow)")
    p_on.add_argument("--host", default="localhost")
    p_on.add_argument("--port", type=int, default=9090,
                      help="rosbridge websocket port (reference default)")
    p_on.add_argument("--duration", type=float, default=None,
                      help="capture window seconds (default: config.time, "
                           "275 s in config_ros.yaml); the SetBool "
                           "service stops earlier, as in the reference")
    p_on.add_argument("--no-refine", action="store_true",
                      help="stop after the causal init (iteration 0)")
    p_on.add_argument("--config", default=None,
                      help="reference-format YAML")
    p_on.add_argument("--iters", type=int, default=None, help="override N")
    p_on.add_argument("--mode", default=None,
                      choices=["sequential", "batched", "ba", "windowed_ba"])
    p_on.add_argument("--profile",
                      choices=["fast", "default", "turbo", "ultra", "max"],
                      default=None)
    p_on.add_argument("--cpu", action="store_true")
    p_on.add_argument("--out", default=None, help="write result .npz here")
    p_on.add_argument("--quiet", action="store_true")
    p_on.add_argument("--plot", default=None, metavar="DIR")
    p_on.add_argument("--export-map", default=None, metavar="PGM")
    p_on.add_argument("--export-tum", default=None, metavar="TXT")
    p_on.set_defaults(fn=cmd_online)

    p_b = sub.add_parser("bench", help="run the headline benchmark")
    p_b.add_argument("rest", nargs="*")
    p_b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
