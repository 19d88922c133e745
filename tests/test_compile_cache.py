"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set, else a fixed git-ignored directory inside the checkout."""
import os

import jax
import pytest

import icm_slam_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
])
def test_cache_dir_rule(environ, expected):
    assert icm_slam_tpu.compilation_cache_dir(environ) == expected


def test_import_sets_the_rule_and_the_dir_is_ignored():
    assert (jax.config.jax_compilation_cache_dir
            == icm_slam_tpu.compilation_cache_dir())
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
