"""Masked scan filter vs the oracle's variable-length filtrar_z."""
import numpy as np
import jax.numpy as jnp

from icm_slam_tpu.frontend.scan_filter import (filter_scans, median3,
                                               preprocess_ranges)
from tests.oracle import reference_oracle as oracle


def _oracle_prep(scans, p):
    z = np.nan_to_num(scans, nan=p.rango_laser_max)
    return np.minimum(z + p.radio, p.rango_laser_max)


def test_median3_matches_scipy():
    from scipy.signal import medfilt
    rng = np.random.default_rng(0)
    r = rng.uniform(0, 10, size=181)
    np.testing.assert_allclose(np.asarray(median3(jnp.asarray(r))),
                               medfilt(r), atol=1e-12)


def test_filter_matches_oracle_on_reference_world_scans(
        seeded_reference_world):
    scans = seeded_reference_world.scans
    p = oracle.OracleParams()
    prep = _oracle_prep(scans, p)
    sel = np.arange(0, seeded_reference_world.T, 97)
    ranges = preprocess_ranges(jnp.asarray(scans[sel], jnp.float64),
                               p.rango_laser_max, p.radio)
    dist, mask = filter_scans(ranges, p.rango_laser_max, p.dist_thr, 181)
    dist, mask = np.asarray(dist), np.asarray(mask)

    n_nonempty = 0
    for i, t in enumerate(sel):
        zz = oracle.scan_filter(prep[t], p)
        kept_beams = np.where(mask[i])[0]
        ref_beams = (zz[:, 1] * 180 / np.pi).round().astype(int)
        np.testing.assert_array_equal(kept_beams, ref_beams,
                                      err_msg=f"frame {t} beam sets differ")
        np.testing.assert_allclose(dist[i][mask[i]], zz[:, 0], atol=1e-9,
                                   err_msg=f"frame {t} ranges differ")
        if len(ref_beams):
            n_nonempty += 1
    assert n_nonempty > 5  # the comparison actually exercised real scans


def test_empty_frames():
    p = oracle.OracleParams()
    # all beams at max range -> empty
    r = jnp.full((3, 181), p.rango_laser_max)
    dist, mask = filter_scans(r, p.rango_laser_max, p.dist_thr, 181)
    assert not bool(mask.any())
    # one valid beam -> still empty (reference needs > 1)
    r = np.full((1, 181), p.rango_laser_max)
    r[0, 90] = 3.0
    # median filter kills a lone dip; craft a 3-beam plateau with 2 isolated
    r[0, 89:92] = 3.0
    dist, mask = filter_scans(jnp.asarray(r), p.rango_laser_max, 0.0001, 181)
    assert not bool(mask.any())  # isolated (neighbors > thr apart)
