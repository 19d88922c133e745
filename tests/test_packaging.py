"""Installed-package smoke test.

Builds/installs the package OUT of the source tree (pip --target, no deps,
no build isolation — offline-safe) and drives a tiny end-to-end run from a
different working directory, so any source-tree-relative path resolution
(the round-1 cli.cmd_bench bug class) fails loudly here.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_pip_install_smoke(tmp_path):
    site = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--no-build-isolation", "--quiet", "--target", str(site), ROOT],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]

    driver = tmp_path / "drive.py"
    driver.write_text(
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import icm_slam_tpu\n"
        "assert 'site' in icm_slam_tpu.__file__, icm_slam_tpu.__file__\n"
        "from icm_slam_tpu.config import ICMConfig\n"
        "from icm_slam_tpu.data.datasets import synthetic_world\n"
        "from icm_slam_tpu.solver.icm import run\n"
        "from icm_slam_tpu.cli import main  # entry point importable\n"
        "import icm_slam_tpu.benchmarks.headline  # in-package bench\n"
        "ds = synthetic_world(T=60, n_landmarks=6, seed=0)\n"
        "res = run(ds, ICMConfig(N=1, L=64, cota=3.0, dtype='float32'))\n"
        "assert res.x.shape == (60, 3)\n"
        "print('INSTALLED-OK', res.map_pos.shape[0])\n")
    env = dict(os.environ, PYTHONPATH=str(site))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, str(driver)], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "INSTALLED-OK" in r.stdout
