"""sigma_clip_combine against a float64 numpy reference of ccdproc's
combine: one sigma-clip pass about the masked median with mad_std
deviation (reference scripts/ap_combine_darks.py:388-420), then a
masked average, median or sum over the frame axis."""

import numpy as np
import pytest

import jax.numpy as jnp

from astrophotography_tpu.ops.stack import sigma_clip_combine


def _ccdproc_combine(stack, mask, method, sigma_lower, sigma_upper):
    """Float64 numpy reference; ``mask`` True = usable sample."""
    data = np.ma.masked_array(stack.astype(np.float64), mask=~mask)
    center = np.ma.median(data, axis=0)
    dev = 1.482602218505602 * np.ma.median(np.ma.abs(data - center), axis=0)
    clipped = np.ma.masked_where(
        (data < center - sigma_lower * dev)
        | (data > center + sigma_upper * dev), data)
    if method == "average":
        out = np.ma.mean(clipped, axis=0)
    elif method == "median":
        out = np.ma.median(clipped, axis=0)
    else:
        return np.ma.sum(clipped, axis=0).filled(0.0)
    return out.filled(np.nan)


@pytest.mark.parametrize("method", ["average", "median", "sum"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2, 7, 24])
def test_sigma_clip_combine_matches_ccdproc_reference(n, masked, method):
    rng = np.random.default_rng(n)
    stack = rng.normal(100.0, 5.0, (n, 16, 24)).astype(np.float32)
    # cosmic-ray-like outliers the clip must reject
    hits = rng.random(stack.shape) < 0.05
    stack[hits] += rng.uniform(200.0, 5000.0, hits.sum()).astype(np.float32)
    mask = np.ones(stack.shape, bool)
    if masked:
        mask = rng.random(stack.shape) > 0.3
        mask[:, 0, 0] = False          # a pixel no frame covers
    got = np.asarray(sigma_clip_combine(
        jnp.asarray(stack), mask=jnp.asarray(mask) if masked else None,
        method=method, sigma_lower=3.0, sigma_upper=3.0))
    want = _ccdproc_combine(stack, mask, method, 3.0, 3.0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-3)
