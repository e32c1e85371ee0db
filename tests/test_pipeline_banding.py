"""Banded/streamed pipeline must match the whole-stack pipeline exactly."""

import numpy as np
import pytest

# whole-pipeline runs at two band counts: full-suite tier
pytestmark = pytest.mark.slow
import jax.numpy as jnp

from astrophotography_tpu.models import PipelineConfig, calibrate_register_stack
from tests.test_register_stack import _make_dithered_stack


def test_banded_matches_unbanded():
    frames, _truths, _ = _make_dithered_stack(n_frames=4, shape=(192, 192),
                                              seed=5)
    base = dict(max_stars=32, match_k=10, detect_nsigma=7.0)
    cfg1 = PipelineConfig(**base, n_bands=1)
    cfg2 = PipelineConfig(**base, n_bands=4, detect_mode="chunked", detect_chunk=2)
    s1, d1 = calibrate_register_stack(jnp.asarray(frames), config=cfg1)
    s2, d2 = calibrate_register_stack(jnp.asarray(frames), config=cfg2)
    a1, a2 = np.asarray(s1), np.asarray(s2)
    diff = np.abs(a1 - a2)
    # band translation folding reassociates the coordinate sum, which can
    # flip floor() at tap boundaries: identical almost everywhere, a few
    # ADU on the handful of pixels whose source coordinate straddles an
    # integer
    assert np.median(diff) < 1e-3
    assert (diff > 1.0).mean() < 0.005
    assert diff.max() < 20.0
    np.testing.assert_allclose(np.asarray(d1["tx"]), np.asarray(d2["tx"]),
                               atol=1e-5)

