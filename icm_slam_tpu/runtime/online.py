"""Online (streaming) SLAM engine — the reference's entry point A, redesigned.

The reference busy-waits on an unsynchronized counter mutated by a Twisted
network thread (ICM_ROS.py:55-56 + ICM_SLAM.py:341 — a real data race,
SURVEY.md §5) and dispatches one scipy fmin per frame.  Here:

* frames arrive through ``push()`` (from any feeder: replay, websocket
  adapter, ROS bridge) into a host-side buffer — an explicit queue, no
  shared-state race;
* the device runs the causal init in CHUNKS (jitted lax.scan over
  ``chunk_size`` frames, carrying the map + pose), overlapping host
  ingestion with device compute and amortizing dispatch latency — the
  per-frame semantics are IDENTICAL to the sequential reference loop;
* ``finish()`` filters the map and optionally runs the offline ICM
  refinement (batched device sweep) over everything captured.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.core.energy import weights
from icm_slam_tpu.core.geometry import beam_angles, beams_to_world
from icm_slam_tpu.frontend.scan_filter import filter_scans, preprocess_ranges
from icm_slam_tpu.mapping.landmark_map import empty_map
from icm_slam_tpu.solver.icm import ICMResult, first_frame_labels
from icm_slam_tpu.solver.sweeps import SweepData, init_chunk


class OnlineSLAM:
    def __init__(self, config: ICMConfig, chunk_size: int = 64,
                 verbose: bool = False):
        self.config = config
        self.chunk = chunk_size
        self.verbose = verbose
        self.dtype = jnp.dtype(config.dtype)
        self._w = weights(config)
        self._ang = beam_angles(config.n_beams, config.beam_step_deg,
                                config.beam0_deg, self.dtype)
        # host-side frame buffers (explicit queue; no shared-state race)
        self._scans, self._odom, self._u = [], [], []
        self._pending = 0
        self._state = None       # MapState carry
        self._xt = None          # last pose carry
        self._poses = []         # committed pose chunks (np arrays)
        self._compiled = None

    # ------------------------------------------------------------------
    def push(self, ranges, odom, u):
        """Ingest one frame (raw ranges (B,), odometry (3,), control (2,))."""
        self._scans.append(np.asarray(ranges, np.float64).reshape(-1))
        self._odom.append(np.asarray(odom, np.float64).reshape(3))
        self._u.append(np.asarray(u, np.float64).reshape(2))
        self._pending += 1
        if self._state is None and len(self._scans) == 1:
            self._bootstrap()
            self._pending = 0
        elif self._pending >= self.chunk:
            self._flush()

    # ------------------------------------------------------------------
    def _filter(self, scans_np):
        scans = jnp.asarray(scans_np, self.dtype)
        r = preprocess_ranges(scans, self.config.rango_laser_max,
                              self.config.radio)
        return filter_scans(r, self.config.rango_laser_max,
                            self.config.dist_thr, self.config.n_beams,
                            self.config.beam_step_deg, self.config.beam0_deg)

    def _bootstrap(self):
        """Frame 0: pose = first odometry; host-clustered map seed."""
        x0 = jnp.asarray(self._odom[0], self.dtype)
        dist, mask = self._filter(np.asarray(self._scans[:1]))
        pts = np.asarray(beams_to_world(x0, dist[0], self._ang))
        m0 = np.asarray(mask[0])
        if m0.any():
            labels = first_frame_labels(pts[m0], self.config.dist_thr)
            from icm_slam_tpu.mapping.landmark_map import seed_from_clusters
            self._state = seed_from_clusters(self.config.L, pts[m0], labels,
                                             self.dtype)
        else:
            self._state = empty_map(self.config.L, self.dtype)
        self._xt = x0
        self._poses.append(np.asarray(x0)[None, :])

    def _flush(self):
        """Run the causal chunk on device for all pending frames."""
        if self._pending == 0 or self._state is None:
            return
        n = self._pending
        total = len(self._scans)
        start = total - n
        # chunk data includes the previous frame's u/odom for the kinematic
        # and odometry terms (t_offset=1 into a window starting at start-1)
        scans_np = np.asarray(self._scans[start - 1:total])
        dist, mask = self._filter(scans_np)
        data = SweepData(
            dist=dist, mask=mask, ang=self._ang,
            odom=jnp.asarray(np.asarray(self._odom[start - 1:total]),
                             self.dtype),
            u=jnp.asarray(np.asarray(self._u[start - 1:total]), self.dtype))
        if self._compiled is None:
            cfg, w = self.config, self._w

            def chunk_fn(data, state, xt):
                return init_chunk(data, state, xt, cfg, w, t_offset=1)

            self._compiled = jax.jit(chunk_fn)
        self._state, self._xt, xs = self._compiled(data, self._state,
                                                   self._xt)
        self._poses.append(np.asarray(xs))
        self._pending = 0
        if self.verbose:
            print(f"[online] processed {total} frames, "
                  f"landmarks={int(self._state.nact)}", flush=True)

    # ------------------------------------------------------------------
    def finish(self, refine: bool = True,
               n_iters: Optional[int] = None) -> ICMResult:
        """Flush, filter the map, optionally refine offline (entry point B).

        Refinement CARRIES the streamed state: the incremental causal init
        computed chunk-by-chunk during the session (map + trajectory) seeds
        the offline ICM sweeps directly — nothing is recomputed.
        """
        import time as _time

        self._flush()
        from icm_slam_tpu.data.datasets import Dataset
        from icm_slam_tpu.mapping.landmark_map import filter_map
        from icm_slam_tpu.solver.icm import check_table_overflow

        # the streamed state's nact is the RAW allocated-label count from
        # update(); labels >= L aliased the discard slot during streaming,
        # so a raw count past L means observations were silently dropped —
        # the same exact-or-error guard run() applies to its init sweep
        if self._state is not None:
            check_table_overflow(int(self._state.nact), self.config.L,
                                 "online init")

        if not self._poses:
            raise RuntimeError(
                "online session captured no frames: nothing was pushed "
                "before finish() (no publisher, or every frame was "
                "dropped by the synchronizer — check its desync stats)")
        x_init = np.concatenate(self._poses, axis=0)
        fm = filter_map(self._state, self.config.cota, self.config.dist_thr)
        if not refine:
            nact = int(fm.nact)
            return ICMResult(
                x_init=x_init, x=x_init, map_pos=np.asarray(fm.pos[:nact]),
                map_counts=np.asarray(fm.counts[:nact]),
                changes=np.zeros((0, 3)), timings={})

        from icm_slam_tpu.solver.icm import (_refine_jit, _refine_loop_jit,
                                             check_witness, hoist_compaction,
                                             kept_count, map_change, prepare,
                                             resolve_config)
        ds = Dataset(np.asarray(self._scans), np.asarray(self._odom),
                     np.asarray(self._u), x_init[0], name="online")
        config = self.config
        n_iters = config.N if n_iters is None else n_iters
        data = prepare(ds, config)
        config = resolve_config(config, data)
        # the same init-map witness run() anchors its chain with: under a
        # map_run_cap (esp. map_run_cap_checked), an over-cap STREAMED init
        # map would feed the cap-sliced refinement paths silently-truncated
        # associations — exact-or-error demands the check here too
        if self._state is not None:
            check_witness(
                jnp.stack([jnp.asarray(int(self._state.nact), jnp.int32),
                           kept_count(self._state, config.cota)]),
                config, "online init")
        data = hoist_compaction(data, config)
        x = jnp.asarray(x_init, data.dist.dtype)
        cur_map = jax.tree.map(lambda a: jnp.asarray(a), fm)
        t0 = _time.perf_counter()
        if not self.verbose:
            # no observer -> the same fused one-program loop run() uses
            # (no per-iteration host dispatch)
            cur_map, x, witnesses, ch = _refine_loop_jit(
                data, cur_map, x, config, n_iters)
            jax.block_until_ready(x)
            raw = list(np.asarray(witnesses)) if n_iters else []
            changes = list(np.asarray(ch))
        else:
            changes, raw = [], []
            for k in range(n_iters):
                prev = cur_map
                cur_map, x, w = _refine_jit(data, prev, x, config)
                changes.append(map_change(cur_map, prev,
                                          live_cap=config.map_run_cap))
                raw.append(w)
                corr = float(jnp.sum(jnp.linalg.norm(
                    x - jnp.asarray(x_init, x.dtype), axis=1)))
                print(f"[online] refine {k + 1}/{n_iters} "
                      f"landmarks={int(cur_map.nact)} "
                      f"correction={corr:.4f}", flush=True)
            jax.block_until_ready(x)
        for k, w in enumerate(raw):
            check_witness(w, config, f"refinement sweep {k}")
        nact = int(cur_map.nact)
        return ICMResult(
            x_init=x_init, x=np.asarray(x),
            map_pos=np.asarray(cur_map.pos[:nact]),
            map_counts=np.asarray(cur_map.counts[:nact]),
            changes=np.asarray([[float(c) for c in ch] for ch in changes]),
            timings={"refine_s": _time.perf_counter() - t0})
