"""Loop-closure capability, quantified against ground truth.

The scan-ICP + pose-graph loop closure (models/loop_closure.py) is
unit-tested; this experiment measures what it buys:

* a synthetic long-loop world with *real* odometry drift — the published
  odometry (and the controls the kinematic potential consumes) are
  integrated from noise-corrupted controls, exactly how a real wheel
  encoder drifts, so the SLAM estimate inherits the drift instead of
  having error injected into it post hoc;
* the full ICM pipeline runs on the drifted data (the reference pipeline
  semantics: init sweep + N refinement sweeps);
* `close_loops` detects revisits from the scans, verifies them with 3-dof
  ICP, and pose-graph-corrects the trajectory;
* ATE vs ground truth is reported for raw odometry, the ICM estimate,
  and the closed trajectory, plus closure count and inlier stats.

The reference has no loop-closure capability at all (SURVEY §2) — this is
a beyond-reference component, so the comparison is against ground truth,
not against a reference trace.

Operating regime (measured): pose-graph closure helps
when the accumulated drift is large against the ICP closure measurement
noise (~6-7 cm RMS here).  Below that — e.g. a short 800-frame run where
ICM alone reaches 0.06 m ATE — the correction substitutes noisier closure
measurements for an already-better estimate and the reported
``improvement_x`` drops below 1 (an A/B of chain-edge sources showed
estimate-relative chains do not fix this; they just under-correct at real
drift, so raw-odometry chains stay the default).

Usage: python benchmarks/loop_closure_eval.py [--frames 2000] [--drift 0.02]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))


def ate(x, x_true):
    return float(np.mean(np.linalg.norm(
        np.asarray(x)[:, :2] - x_true[:, :2], axis=1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--landmarks", type=int, default=150)
    ap.add_argument("--world", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--v-noise", type=float, default=0.03,
                    help="white noise std on forward speed [m/s]")
    ap.add_argument("--w-noise", type=float, default=0.004,
                    help="white noise std on yaw rate [rad/s]")
    ap.add_argument("--w-bias", type=float, default=0.001,
                    help="constant yaw-rate bias [rad/s] (the classic "
                         "unbounded-drift term)")
    ap.add_argument("--laps", type=int, default=2,
                    help="circuits of the loop; >= 2 makes the whole "
                         "second lap a revisit")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--rounds", type=int, default=3,
                    help="detect->correct rounds (each shrinks drift, "
                         "unlocking more closures)")
    ap.add_argument("--radius", type=float, default=6.0)
    ap.add_argument("--min-gap", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import drifted_world
    from icm_slam_tpu.models.loop_closure import close_loops
    from icm_slam_tpu.solver.icm import prepare, resolve_config, run

    ds, x_true, _ = drifted_world(T=args.frames, n_landmarks=args.landmarks,
                                  world_size=args.world, seed=args.seed,
                                  v_noise=args.v_noise, w_noise=args.w_noise,
                                  w_bias=args.w_bias, laps=args.laps)
    ate_odo = ate(ds.odom, x_true)
    end_gap = float(np.linalg.norm(ds.odom[-1, :2] - x_true[-1, :2]))

    cfg = ICMConfig(N=args.iters, L=1024, cota=10.0, dtype="float32")
    res = run(ds, cfg)
    ate_icm = ate(res.x, x_true)

    data = prepare(ds, cfg)
    rcfg = resolve_config(cfg, data)
    guard = {}
    x_fix, cl = close_loops(data, jnp.asarray(res.x), rcfg,
                            min_gap=args.min_gap, radius=args.radius,
                            icp_coarse_gate=4.0, gn_iters=20, cg_iters=400,
                            rounds=args.rounds, report=guard)
    ate_closed = ate(x_fix, x_true)

    report = {
        "metric": "loop_closure_ate_m",
        "frames": args.frames,
        "ate_odometry_m": round(ate_odo, 4),
        "odometry_endpoint_gap_m": round(end_gap, 4),
        "ate_icm_m": round(ate_icm, 4),
        "ate_after_closure_m": round(ate_closed, 4),
        "improvement_x": round(ate_icm / max(ate_closed, 1e-9), 2),
        "closures_accepted": int(cl.pairs.shape[0]),
        "inlier_frac_mean": round(float(np.mean(cl.inliers)), 3)
        if cl.pairs.shape[0] else None,
        "inlier_rms_mean_m": round(float(np.mean(cl.rms)), 4)
        if cl.pairs.shape[0] else None,
        # per-round regime-guard decisions (applied / est_drift vs gate):
        # in the low-drift regime the guard no-ops instead of regressing
        "guard_rounds": guard.get("rounds", []),
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
