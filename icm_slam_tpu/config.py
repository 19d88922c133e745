"""Typed configuration for the ICM-SLAM engine.

Parameter names and semantics are 1:1 with the reference YAML schema
(``config_ros.yaml`` / ``config_default.yaml``; parsed by ConfigICM at
reference ICM_SLAM.py:60-102), so existing reference configs load unchanged.
Engine knobs live in their own namespace and have safe defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ICMConfig:
    """Physics / algorithm parameters (reference-compatible)."""

    # --- reference parameters (config_ros.yaml keys) ---
    N: int = 30                      # outer ICM iterations
    deltat: float = 0.1              # sampling period [s]
    L: int = 1024                    # landmark table capacity
    Q: Tuple[float, float] = (1.0, 1.0)          # observation weight diag
    R: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # motion-model weight diag
    cte_odom: float = 1.0            # odometry-residual weight
    cota: float = 300.0              # min observations to keep a landmark
    dist_thr: float = 1.0            # association / merge distance gate [m]
    dist_thr_obs: float = 1.0        # accepted for YAML compat; the
                                     # reference parses but never uses it
                                     # (ICM_SLAM.py:88)
    rango_laser_max: float = 10.0    # lidar max range [m]
    radio: float = 0.137             # tree trunk radius compensation [m]
    time: float = 275.0              # online capture window [s]
    file: str = "data_IJAC2018.mat"

    # --- sensor geometry ---
    n_beams: int = 181               # beams per scan (offline .mat layout)
    beam0_deg: float = 0.0           # angle of beam 0 in the scan frame
    beam_step_deg: float = 1.0

    # --- ROS topics (online mode; kept for config compatibility) ---
    topic_laser: str = "/pioneer2dx/laser/scan_Lidar_horizontal"
    topic_laser_msg: str = "sensor_msgs/LaserScan"
    topic_odometry: str = "/pioneer2dx/ground_truth/odom"
    topic_odometry_msg: str = "nav_msgs/Odometry"

    # --- engine knobs (new; not in the reference) ---
    sweep_mode: str = "batched"      # sequential | batched | ba | windowed_ba
    init_mode: str = "auto"          # auto | sequential | batched — iteration-0
                                     # engine; auto = batched Picard rounds
                                     # whenever the sweep is batched and the
                                     # default kinematics/quirk apply, else
                                     # the faithful sequential scan
    init_chunk_len: int = 32         # frames per chunk of the batched init.
                                     # Its Picard rounds run to the fixed
                                     # point, so this sets the cost (scan
                                     # steps against rounds per chunk), not
                                     # the result
    init_merge_cap: int = 0          # width of the batched init's final
                                     # duplicate merge: 0 = full L (default;
                                     # nothing bounds the raw allocated-
                                     # label count a priori, so this cap is
                                     # opt-in), -1 = follow map_run_cap,
                                     # >0 explicit.  Runtime-witnessed: the
                                     # merge sees ALL allocated labels, so
                                     # exactness needs raw_nact <= cap —
                                     # run() errors otherwise (pointing
                                     # back at init_merge_cap=0)
    init_final_assoc: bool = True    # rebuild the chunk's committed table
                                     # from the CONVERGED poses (one extra
                                     # association pass per chunk).  False
                                     # commits the last Picard round's
                                     # masses (computed at that round's
                                     # pre-solve predictions) — one pass
                                     # less sequential depth per chunk;
                                     # opt-in pending quality validation
    init_gn_iters: int = 0           # LM iterations per init pose solve in
                                     # the BATCHED init only (0 =
                                     # pose_gn_iters; the sequential init
                                     # always uses pose_gn_iters).  The
                                     # Picard rounds re-solve every pose, so
                                     # cheaper inner solves may lose nothing
    pose_gn_iters: int = 8           # LM iterations per pose solve
    pose_passes: int = 2             # red-black half-pass pairs per batched sweep
    pose_update: str = "redblack"    # redblack | jacobi — batched-sweep pose
                                     # update order.  redblack = Gauss-Seidel
                                     # half-passes (fresh odd neighbours for
                                     # the even pass); jacobi = one full pass
                                     # per pose_pass against the previous
                                     # pass's neighbours — half the
                                     # sequential LM depth (the sweep is
                                     # latency-bound), different fixed-point
                                     # path; opt-in, quality-gated
    replicate_new_obs_quirk: bool = True  # ICM_SLAM.py:176 empty-slice quirk
    obs_cap: int = 0                 # compact pose solves to this many beams
                                     # per frame (0 = no compaction; set >=
                                     # the dataset's max valid-beam count —
                                     # solver.sweeps.auto_obs_cap — for an
                                     # exact but much cheaper solve)
    map_run_cap: int = 256           # running-mean table width for OLD
                                     # landmarks in the batched sweep
                                     # (0 = full L); run() disables it when
                                     # the provable live-landmark bound
                                     # (total_obs / cota) exceeds it
    map_run_cap_checked: bool = False  # keep the cap even when the provable
                                     # bound exceeds it, and VERIFY at
                                     # runtime instead: every sweep's
                                     # surviving-landmark count is witnessed
                                     # on-device and run() raises if one
                                     # ever reaches the cap.  For worlds
                                     # whose cota bound is loose but whose
                                     # real landmark count is small (e.g.
                                     # the 300-landmark stress world) this
                                     # keeps the fast association + filter
                                     # paths exact-or-error, never silent
    assoc_onehot_max_elems: int = 32_000_000
                                     # size gate for the one-hot-matmul
                                     # running-mean build in the batched
                                     # sweep: used when T*B*(cap+1) fits,
                                     # else chunked one-hot sums (refine) or
                                     # scatter segment-sums (init) — the
                                     # materialized one-hot is too large at
                                     # 20k-frame stress scale.  0 disables
                                     # one-hot.
    ba_gn_iters: int = 4             # outer GN steps per BA refinement
    ba_cg_iters: int = 12            # PCG iterations per GN step; block-
                                     # Jacobi preconditioning makes 12
                                     # match unpreconditioned 60 exactly
                                     # (full-depth ATE 0.0911 vs 0.0912)
    ba_window: int = 64              # keyframe block size (windowed_ba mode)
    dtype: str = "float32"
    # user-extensible energy hooks (core.energy.EnergyModel); None = default.
    # The reference's subclass hooks g_/h_/fun_x_/fun_xn_ (example.py:13-35)
    model: Optional[Any] = None

    # NOTE: the reference's ConfigICM.set_Tf (ICM_SLAM.py:101-102) recorded
    # the trajectory length post-hoc; here T always derives from the data.

    @staticmethod
    def from_yaml(path: str, **overrides) -> "ICMConfig":
        """Load a reference-format YAML (top-level key ``D``)."""
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f)
        d = data.get("D", data)
        known = {f.name for f in dataclasses.fields(ICMConfig)}
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                continue
            if k in ("Q", "R"):
                v = tuple(float(x) for x in v)
            kwargs[k] = v
        kwargs.update(overrides)
        return ICMConfig(**kwargs)
