"""Full float32 precision on the small matrix products whose results
are pinned to float64 references: a GPU runs a default-precision f32
product in TF32, which keeps only ~3 decimal digits."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from astrophotography_tpu import synth
from astrophotography_tpu.ops.background import background2d
from astrophotography_tpu.ops.demosaic import raw_to_grey_linear
from astrophotography_tpu.ops.psf import fit_gaussian2d


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def _psf_fit():
    n = 5
    return jax.make_jaxpr(lambda c: fit_gaussian2d(
        c, jnp.ones(n, bool), jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.int32)))(jnp.zeros((n, 16, 16)))


def _background_zoom():
    return jax.make_jaxpr(lambda d: background2d(d, upsample="spline"))(
        jnp.zeros((64, 64)))


def _luma():
    cmap = synth.bayer_color_map((16, 16))
    return jax.make_jaxpr(lambda m: raw_to_grey_linear(
        m, cmap, jnp.zeros(4), jnp.ones(4)))(jnp.zeros((16, 16), jnp.uint16))


@pytest.mark.parametrize("make", [_psf_fit, _background_zoom, _luma],
                         ids=["psf", "background_zoom", "luma"])
def test_dot_generals_run_at_highest_precision(make):
    precisions = _dot_precisions(make().jaxpr, [])
    assert precisions, "no matrix product found"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
