"""Test configuration: 8 virtual CPU devices, x64 available for parity tests.

The multi-device CPU mesh is the accelerator analog of the reference's
Docker-rosbridge fake network (SURVEY.md §4): it lets sharding/collective
paths run and be validated without accelerator hardware.  Tests that need
the GPU carry the ``gpu`` marker, take the ``gpu_device`` fixture and skip
on the CPU.  ``ICM_TESTS_ON_GPU=1`` leaves JAX its default platform, so on
a machine with a GPU

    ICM_TESTS_ON_GPU=1 python -m pytest tests -m gpu

runs them there.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("ICM_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    XLA:CPU in this environment segfaults inside backend_compile after
    ~85 tests' worth of accumulated live executables in one process
    (deterministic at the same test index across runs; every module
    passes in isolation).  Capping the live-executable count avoids the
    crasher at the cost of some recompilation."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def seeded_reference_world():
    """The seeded world at the reference dataset's shapes
    (icm_slam_tpu.data.datasets.REFERENCE_WORLD)."""
    from icm_slam_tpu.data.datasets import reference_world
    return reference_world()


@pytest.fixture(scope="session")
def golden_small():
    """NumPy-oracle trace of the first 400 frames at N=3."""
    return np.load(os.path.join(GOLDEN_DIR,
                                "reference_T400_N3_inconsistent.npz"))


@pytest.fixture(scope="session")
def golden_full():
    """NumPy-oracle trace of the whole world at N=30."""
    return np.load(os.path.join(GOLDEN_DIR,
                                "reference_T1833_N30_inconsistent.npz"))


@pytest.fixture
def gpu_device():
    """The first GPU; skips when JAX sees none (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; run on the card with "
                    "`ICM_TESTS_ON_GPU=1 python -m pytest tests -m gpu`")
    return gpus[0]
