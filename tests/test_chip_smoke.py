"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to
run without a GPU.  The full-width run is ``python chip_smoke.py`` on the
card; ``test_chip_smoke_on_gpu`` runs the phases there at the tiny size."""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.data.datasets import reference_world, synthetic_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ICMConfig(N=2, L=64, cota=3.0)


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def tiny_world():
    return synthetic_world(T=60, n_landmarks=8, seed=0, return_truth=True)


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    assert capsys.readouterr().out == ""


def test_lone_script_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_reference_config_is_the_default():
    # chip_smoke runs ICMConfig() as configs/reference.yaml's physics
    assert ICMConfig.from_yaml(
        os.path.join(ROOT, "configs", "reference.yaml")) == ICMConfig()


def test_main_path_and_cpu_check(cpu, tiny_world, capsys):
    ds, truth, _ = tiny_world
    res = chip_smoke.main_path(cpu, ds, truth, TINY, "tiny")
    assert res.x.shape == (ds.T, 3)
    mean, mx = chip_smoke.cpu_check(res, ds, TINY, cpu, "tiny")
    assert mean == 0.0 and mx == 0.0
    out = capsys.readouterr().out
    assert "memory_analysis" in out and "census" in out


def test_main_path_against_the_oracle_golden(cpu, capsys):
    from tests.oracle.reference_oracle import OracleParams, run_pipeline
    ds = reference_world().slice(120)
    golden = run_pipeline(np.ascontiguousarray(ds.scans.T),
                          np.ascontiguousarray(ds.odom.T),
                          np.ascontiguousarray(ds.u.T), OracleParams(N=1),
                          verbose=False)
    chip_smoke.main_path(cpu, ds, golden["x"].T, ICMConfig(N=1), "slice",
                         golden)
    assert "against the NumPy oracle" in capsys.readouterr().out


def test_oracle_check(cpu):
    ds = reference_world().slice(200)
    ate = chip_smoke.oracle_check(cpu, ds, ICMConfig(N=1))
    assert ate < chip_smoke.ORACLE_ATE_TOL


def test_precision_check(cpu, tiny_world):
    outs = chip_smoke.precision_check(cpu, cpu, tiny_world[0], TINY)
    # the CPU computes float32 dots exactly at either precision
    np.testing.assert_array_equal(outs["default"][1], outs["highest"][1])


def test_fleet_check(cpu, capsys):
    worlds = [synthetic_world(T=60, n_landmarks=8, seed=s) for s in (0, 1)]
    assert len(chip_smoke.fleet_check(cpu, worlds, TINY)) == 2
    # on the CPU the vmapped and solo programs agree bit for bit
    assert "0 beams labelled differently" in capsys.readouterr().out


def test_label_flips_counts_a_moved_pose(tiny_world):
    from icm_slam_tpu.solver.icm import run
    ds = tiny_world[0]
    res = run(ds, TINY)
    assert chip_smoke.label_flips(ds, TINY, res, res)[0] == 0
    lab, _ = chip_smoke.beam_labels(ds, TINY, res.x, res.map_pos)
    t = int((lab >= 0).sum(1).argmax())
    x = res.x.copy()
    x[t, :2] += 5.0 * TINY.dist_thr
    moved = dataclasses.replace(res, x=x)
    flips, _, frame, seen = chip_smoke.label_flips(ds, TINY, res, moved)
    assert flips == seen == int((lab[t] >= 0).sum()) > 0 and frame == t


def test_trace_check_finds_the_association_block(cpu, tiny_world,
                                                 tmp_path):
    shares = chip_smoke.trace_check(cpu, tiny_world[0], TINY, str(tmp_path))
    assert 0.0 < shares["association"] < 1.0
    assert shares["pose_solve"] > 0.0


def test_four_cards_on_four_cpu_devices(monkeypatch, capsys):
    import functools
    import icm_slam_tpu.data.datasets as datasets
    monkeypatch.setattr(datasets, "reference_world",
                        functools.partial(reference_world, T=120))
    monkeypatch.setattr(chip_smoke, "FLEET_WORLDS", 3)
    chip_smoke.four_cards(jax.devices("cpu")[:4])
    out = capsys.readouterr().out
    assert "[four fleet W=3]" in out and "0 of 120 poses beyond" in out


def test_hlo_op_names_parses_metadata():
    text = ('  %fusion.3 = f32[8]{0} fusion(f32[8]{0} %p), kind=kLoop, '
            'calls=%fc, metadata={op_name="jit(f)/association/sub" '
            'source_file="x.py"}\n'
            '  ROOT %t = (f32[8]{0}) tuple(%fusion.3)\n')
    assert chip_smoke.hlo_op_names(text) == {
        "fusion.3": "jit(f)/association/sub"}


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_device, cpu, tiny_world, tmp_path):
    """The phases on the card at the tiny size, in this process (a second
    JAX process could not take the card); the full-width run is
    ``python chip_smoke.py``."""
    ds, truth, _ = tiny_world
    res = chip_smoke.main_path(gpu_device, ds, truth, TINY, "tiny")
    chip_smoke.cpu_check(res, ds, TINY, cpu, "tiny")
    outs = chip_smoke.precision_check(gpu_device, cpu, ds, TINY)
    assert np.isfinite(outs["default"][1]).all()
    shares = chip_smoke.trace_check(gpu_device, ds, TINY, str(tmp_path))
    assert 0.0 < shares["association"] < 1.0
