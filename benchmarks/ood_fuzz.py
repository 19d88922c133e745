"""Out-of-distribution robustness fuzz: candidate config vs default.

The real datasets (1833 frames, 11 landmarks, mild drift) are easy mode;
a speed knob that is quality-green there can still destabilize the ICM
fixed point on harder worlds.  This harness re-runs round 3's ad-hoc
protocol as a checked-in tool: N random hard synthetic worlds (varying
landmark density, random-walk odometry drift), full pipeline with the
default config vs the default+overrides candidate, compared on

* landmark census (mapped landmark count — a divergence means the
  candidate reached a DIFFERENT ICM fixed point), and
* ATE vs the known TRUE trajectory (not a golden trace — these worlds
  have ground truth).

Round-3 findings reproduced by this tool: ``pose_update=jacobi`` diverges
on 0/10 worlds; the C=64 init recipe diverges on 9/10.

    python benchmarks/ood_fuzz.py '{"init_gn_iters": 4}' [--worlds 10]
                                  [--iters 15] [--ate-tol 0.02]

Prints one cumulative JSON line per world (harness-timeout-safe); the
final line carries the verdict counts.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("overrides",
                    help="JSON dict of ICMConfig overrides for the "
                         "candidate, e.g. '{\"init_gn_iters\": 4}'")
    ap.add_argument("--worlds", type=int, default=10)
    ap.add_argument("--iters", type=int, default=15,
                    help="outer ICM iterations per run")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--ate-tol", type=float, default=0.02,
                    help="|ATE_cand - ATE_default| above this (meters) "
                         "counts as an ATE divergence even at equal census")
    ap.add_argument("--baseline", default="{}",
                    help="JSON dict of ICMConfig overrides for the BASELINE "
                         "side (default: the engine default config).  Use "
                         "to fuzz a candidate against an already-shipped "
                         "profile, e.g. a deeper-turbo knob against turbo: "
                         "--baseline '{\"pose_passes\":1,"
                         "\"pose_gn_iters\":3}'")
    args = ap.parse_args()
    overrides = json.loads(args.overrides)
    baseline = json.loads(args.baseline)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import synthetic_world
    from icm_slam_tpu.solver.icm import run

    # L=1024: the hard worlds allocate hundreds of provisional labels per
    # sweep before the cota prune (an L=256 table overflows the witness).
    # User overrides are applied LAST so a --baseline/--overrides JSON may
    # legitimately re-set N/L/dtype without a TypeError.
    base = ICMConfig(**{"N": args.iters, "L": 1024, "dtype": "float32",
                        **baseline})
    cand = ICMConfig(**{"N": args.iters, "L": 1024, "dtype": "float32",
                        **overrides})

    rows = []
    out = {"metric": "ood_fuzz", "overrides": overrides,
           "baseline": baseline,
           "worlds": args.worlds, "iters": args.iters, "rows": rows}
    census_div = ate_div = 0
    for seed in range(args.worlds):
        rng = np.random.default_rng(1000 + seed)
        n_lm = int(rng.integers(15, 79))
        ds, x_true, _ = synthetic_world(
            T=args.frames, n_landmarks=n_lm, seed=seed, loop=True,
            odo_drift=2e-3, return_truth=True)
        res_b = run(ds, base)
        res_c = run(ds, cand)
        ate = lambda r: float(np.mean(np.linalg.norm(
            r.x[:, :2] - x_true[:, :2], axis=1)))
        ate_b, ate_c = ate(res_b), ate(res_c)
        row = {"seed": seed, "n_landmarks_world": n_lm,
               "census_default": res_b.map_pos.shape[0],
               "census_candidate": res_c.map_pos.shape[0],
               "ate_default": round(ate_b, 4),
               "ate_candidate": round(ate_c, 4)}
        row["census_diverged"] = \
            row["census_default"] != row["census_candidate"]
        row["ate_diverged"] = abs(ate_c - ate_b) > args.ate_tol
        census_div += row["census_diverged"]
        ate_div += row["ate_diverged"]
        rows.append(row)
        out["census_divergences"] = census_div
        out["ate_divergences"] = ate_div
        print(f"# seed {seed}: census {row['census_default']}/"
              f"{row['census_candidate']}, ATE {ate_b:.3f}/{ate_c:.3f}",
              file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
