"""Multi-process jax.distributed validation.

Spawns REAL separate OS processes that initialize jax.distributed, form
one global CPU mesh, build host-local shards
(jax.make_array_from_process_local_data), run a full batched ICM step,
and assert the result equals an independent single-device recomputation.
This is the CI-able stand-in for a multi-host GPU job (Gloo plays the
role of NCCL over NVLink or the network).
"""
import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                    "dryrun_multiprocess.py")


@pytest.mark.slow
def test_two_process_distributed_step_matches_local():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the tool sets its own device count
    out = subprocess.run(
        [sys.executable, TOOL, "--nproc", "2", "--devices-per-proc", "2"],
        capture_output=True, text=True, timeout=540, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIPROCESS OK" in out.stdout, out.stdout
