"""Pipeline parallelism (SURVEY §2.3 PP row): GPipe-style stage mesh.

Runs on the conftest-forced 8-virtual-CPU-device mesh; uses 3 of the
devices as pipeline stages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig
from icm_slam_tpu.core.energy import weights
from icm_slam_tpu.parallel.pipeline import (make_stage_mesh, pipeline_stages,
                                            pipelined_refine_pass)


def test_pipeline_stages_generic():
    """3-stage arithmetic pipeline == sequential composition per chunk."""
    mesh = make_stage_mesh(3)
    consts = {"scale": jnp.asarray(2.0)}
    chunks = jnp.arange(24, dtype=jnp.float32).reshape(6, 4)

    def make_payload(c, i):
        return {"v": jax.lax.dynamic_index_in_dim(chunks, i, 0,
                                                  keepdims=False)}

    s1 = lambda c, p: {"v": p["v"] + 1.0}
    s2 = lambda c, p: {"v": p["v"] * c["scale"]}
    s3 = lambda c, p: {"v": p["v"] - 3.0}

    out = pipeline_stages(mesh, [s1, s2, s3], make_payload, 6, consts)
    expect = (chunks + 1.0) * 2.0 - 3.0
    np.testing.assert_allclose(np.asarray(out["v"]), np.asarray(expect))


@pytest.mark.parametrize("chunk", [16, 64])
def test_pipelined_refine_matches_barrier(seeded_reference_world, chunk):
    """Pipelined 3-stage half-passes == refine_sweep_batched (exact math,
    different schedule)."""
    from icm_slam_tpu.solver.icm import (_filter_jit, _init_jit, prepare,
                                         resolve_config, seed_map)
    from icm_slam_tpu.solver.sweeps import refine_sweep_batched

    ds = seeded_reference_world.slice(201)
    # map_run_cap=0: this test isolates the SCHEDULE (pipeline vs barrier);
    # the cap-sliced fast paths have their own bitwise equivalence test
    # (test_guards.test_map_run_cap_shrinks_to_bound_and_stays_exact), and
    # a borderline LM accept/reject flips under the cap's different f32
    # reduction shapes, amplifying the schedule comparison past tolerance
    cfg = ICMConfig(N=1, L=256, dtype="float32", map_run_cap=0)
    data = prepare(ds, cfg)
    cfg = resolve_config(cfg, data)
    x0 = jnp.asarray(ds.x0, data.dist.dtype)
    st, x, _ = _init_jit(data, seed_map(data, x0, cfg), x0, cfg)
    cur = _filter_jit(st, cfg)
    w = weights(cfg)

    m_ref, x_ref = jax.jit(
        lambda d, m, xx: refine_sweep_batched(d, m, xx, cfg, w))(data, cur, x)

    mesh = make_stage_mesh(3)
    m_pp, x_pp = jax.jit(
        lambda d, m, xx: pipelined_refine_pass(d, m, xx, cfg, w, mesh,
                                               chunk=chunk))(data, cur, x)

    # same math, different vmap batch shapes -> f32 reduction-order noise
    # (observed max 3e-5 on one borderline LM accept/reject)
    np.testing.assert_allclose(np.asarray(x_pp), np.asarray(x_ref),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(m_pp.pos), np.asarray(m_ref.pos),
                               atol=1e-5)
    assert int(m_pp.nact) == int(m_ref.nact)
