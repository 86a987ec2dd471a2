"""Direct-difference distances and the fused membership test vs float64.

``pairwise_sqdist`` accumulates per axis in a static loop, and the fused
rejection path's membership test (``fused._radius_member``) is that
loop fused with the radius compare and the ``any`` over live points.
Both are checked against a numpy float64 brute force over the
dimensionalities the samplers meet, with padded (masked) live sets, and
in the tiny-scale regime where the Gram identity cancels.
"""
import numpy as np
import pytest

import jax

from ultranest_tpu.fused import _radius_member
from ultranest_tpu.ops.pairwise import pad_rows, pairwise_sqdist

DIMS = [1, 2, 5, 16, 50]


def _sqdist64(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(axis=2)


@pytest.mark.parametrize('d', DIMS)
def test_pairwise_sqdist_matches_float64(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(37, d)).astype(np.float32)
    b = rng.normal(size=(70, d)).astype(np.float32)
    got = np.asarray(jax.jit(pairwise_sqdist)(a, b))
    assert got.shape == (37, 70)
    np.testing.assert_allclose(got, _sqdist64(a, b), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize('d', DIMS)
def test_radius_member_padded_matches_float64(d):
    """Padding rows (masked out) never count, whatever their position."""
    rng = np.random.default_rng(100 + d)
    nvalid, npad, m = 40, 64, 256
    tpoints = rng.normal(size=(nvalid, d)).astype(np.float32)
    # padded rows sit exactly on some candidates: only the mask keeps
    # them out
    cands = np.concatenate([
        tpoints[rng.integers(0, nvalid, m - 16)]
        + rng.normal(size=(m - 16, d)).astype(np.float32),
        np.full((16, d), 0.25, np.float32)])
    tp = pad_rows(tpoints, npad, fill=0.25)
    tmask = np.arange(npad) < nvalid
    d2 = _sqdist64(tpoints, cands)
    mind = d2.min(axis=0)
    r2 = np.float32(np.median(mind))
    got = np.asarray(jax.jit(_radius_member)(cands, tp, tmask, r2))
    expected = mind <= float(r2)
    borderline = np.abs(mind - float(r2)) <= 1e-6 * float(r2)
    assert got.shape == (m,)
    assert ((got == expected) | borderline).all()
    assert 0 < expected.sum() < m


@pytest.mark.parametrize('d', [2, 5])
def test_radius_member_tiny_scale(d):
    """Clusters 1e-5 wide far from the origin: the Gram identity's f32
    cancellation (~1e-7 |x|^2) would swamp r2 ~ 1e-10; direct
    differences of nearby f32 values are exact."""
    rng = np.random.default_rng(200 + d)
    tpoints = (0.8 + 1e-5 * rng.normal(size=(64, d))).astype(np.float32)
    cands = (0.8 + 1e-5 * rng.normal(size=(128, d))).astype(np.float32)
    tmask = np.ones(64, bool)
    mind = _sqdist64(tpoints, cands).min(axis=0)
    r2 = np.float32(np.median(mind))
    got = np.asarray(jax.jit(_radius_member)(cands, tpoints, tmask, r2))
    expected = mind <= float(r2)
    # f32 rounding of the coordinates flips only near-borderline cases
    assert (got == expected).mean() > 0.95
    d2 = np.asarray(jax.jit(pairwise_sqdist)(tpoints, cands))
    np.testing.assert_allclose(d2, _sqdist64(tpoints, cands), rtol=1e-3)
