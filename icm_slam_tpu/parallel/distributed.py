"""Multi-host initialization + distributed helpers.

One process per host, standard JAX multi-controller setup: call
``initialize()`` early (before any jax op), then every host runs the same
program; `parallel.mesh.make_mesh()` over `jax.devices()` spans the full
slice and the GSPMD-sharded sweeps communicate over ICI/DCN automatically.

The reference's only "distribution" was a websocket to a ROS network
(SURVEY.md §2.3); there is no counterpart — this is the engine's own scaling
path (BASELINE config 5: multi-host partitioned map / distributed BA).
"""
from __future__ import annotations

from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks (no-op if single
    process and no coordinator is configured).

    Fallbacks: ICM_COORDINATOR (host:port), ICM_NUM_PROCESSES,
    ICM_PROCESS_ID — so a launcher can configure the whole bring-up through
    the environment and every worker just calls ``initialize()``.  Both the
    explicit-args and the env paths are exercised by
    tools/dryrun_multiprocess.py (in-suite at 2 processes,
    tests/test_multiprocess.py).
    """
    import os

    import jax
    if coordinator_address is None:
        coordinator_address = os.environ.get("ICM_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("ICM_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("ICM_PROCESS_ID")
        process_id = int(v) if v is not None and v != "" else None
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_primary() -> bool:
    import jax
    return jax.process_index() == 0


def global_mesh():
    """1-D time-axis mesh over every device in the slice (all hosts)."""
    from icm_slam_tpu.parallel.mesh import make_mesh
    import jax
    return make_mesh(jax.devices())
