"""Tests for registration, warping, and the fused pipeline."""

import numpy as np
import pytest

from astrophotography_tpu import synth
from astrophotography_tpu.models import PipelineConfig, calibrate_register_stack
from astrophotography_tpu.ops.register import Similarity, estimate_similarity, solve_similarity
from astrophotography_tpu.ops.warp import warp_affine_bilinear, warp_affine_lanczos3

import jax
import jax.numpy as jnp


def _apply_sim(x, y, scale, theta, tx, ty):
    c = scale * np.cos(theta)
    s = scale * np.sin(theta)
    return c * x - s * y + tx, s * x + c * y + ty


def _star_table(x, y, flux, cap=64):
    n = len(x)
    pad = cap - n
    return (np.pad(x, (0, pad)).astype(np.float32),
            np.pad(y, (0, pad)).astype(np.float32),
            np.pad(flux, (0, pad)).astype(np.float32),
            np.pad(np.ones(n, bool), (0, pad)))


def test_solve_similarity_closed_form():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (20, 2))
    scale, theta, tx, ty = 1.02, 0.05, 5.0, -3.0
    dx, dy = _apply_sim(src[:, 0], src[:, 1], scale, theta, tx, ty)
    dst = np.stack([dx, dy], axis=1)
    s, th, ox, oy = (float(v) for v in solve_similarity(
        jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
        jnp.ones(20, jnp.float32)))
    assert s == pytest.approx(scale, abs=1e-4)
    assert th == pytest.approx(theta, abs=1e-4)
    assert ox == pytest.approx(tx, abs=1e-2)
    assert oy == pytest.approx(ty, abs=1e-2)


@pytest.mark.parametrize("theta,txy", [(0.0, (10.3, -7.2)),
                                       (0.03, (3.0, 4.0)),
                                       (-0.1, (-15.0, 8.0))])
def test_estimate_similarity_recovers_transform(theta, txy):
    rng = np.random.default_rng(1)
    n = 30
    rx = rng.uniform(20, 230, n)
    ry = rng.uniform(20, 230, n)
    flux = rng.uniform(1000, 50000, n)
    tx_s, ty_s = _apply_sim(rx, ry, 1.0, theta, *txy)
    # shuffle target order, drop 5 stars, add 5 spurious
    perm = rng.permutation(n)
    keep = perm[:n - 5]
    sx = np.concatenate([tx_s[keep], rng.uniform(0, 250, 5)])
    sy = np.concatenate([ty_s[keep], rng.uniform(0, 250, 5)])
    sf = np.concatenate([flux[keep], rng.uniform(1000, 50000, 5)])
    ref = _star_table(rx, ry, flux)
    tgt = _star_table(sx, sy, sf)
    sim = estimate_similarity(*ref, *tgt, k=16)
    assert float(sim.scale) == pytest.approx(1.0, abs=5e-3)
    assert float(sim.theta) == pytest.approx(theta, abs=2e-3)
    assert float(sim.tx) == pytest.approx(txy[0], abs=0.3)
    assert float(sim.ty) == pytest.approx(txy[1], abs=0.3)
    assert int(sim.n_inliers) >= 8


def test_warp_identity_preserves_image():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1000, (32, 32)).astype(np.float32)
    ident = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32)
    out, wgt = warp_affine_lanczos3(img, ident, (32, 32))
    np.testing.assert_allclose(np.asarray(out), img, rtol=1e-4, atol=1e-2)
    interior = np.asarray(wgt)[3:-3, 3:-3]
    np.testing.assert_allclose(interior, 1.0, atol=1e-5)


def test_warp_pure_translation_shifts():
    img = np.zeros((32, 32), np.float32)
    img += synth.gaussian_star((32, 32), 16.0, 16.0, 10000.0, 3.0).astype(np.float32)
    # map output (x,y) -> input (x+3, y-2): moves the star to (13, 18)
    m = jnp.asarray([[1.0, 0.0, 3.0], [0.0, 1.0, -2.0]], jnp.float32)
    out, _ = warp_affine_lanczos3(img, m, (32, 32))
    out = np.asarray(out)
    peak = np.unravel_index(out.argmax(), out.shape)
    assert peak == (18, 13)
    # Lanczos3 on a smooth Gaussian: peak amplitude preserved closely
    assert out.max() == pytest.approx(img.max(), rel=0.02)


def test_warp_subpixel_flux_conservation():
    img = np.zeros((48, 48), np.float32)
    img += synth.gaussian_star((48, 48), 24.0, 24.0, 20000.0, 3.0).astype(np.float32)
    m = jnp.asarray([[1.0, 0.0, 0.37], [0.0, 1.0, -0.61]], jnp.float32)
    out, _ = warp_affine_lanczos3(img, m, (48, 48))
    assert float(np.asarray(out).sum()) == pytest.approx(img.sum(), rel=1e-3)


def test_bilinear_warp_translation():
    img = np.zeros((32, 32), np.float32)
    img[10, 12] = 100.0
    m = jnp.asarray([[1.0, 0.0, 0.5], [0.0, 1.0, 0.0]], jnp.float32)
    out, _ = warp_affine_bilinear(img, m, (32, 32))
    out = np.asarray(out)
    assert out[10, 11] == pytest.approx(50.0)
    assert out[10, 12] == pytest.approx(50.0)


def _make_dithered_stack(n_frames=6, shape=(192, 192), seed=3):
    """Lights of the same field with per-frame dithers + rotation."""
    rng = np.random.default_rng(seed)
    base_x = rng.uniform(25, shape[1] - 25, 18)
    base_y = rng.uniform(25, shape[0] - 25, 18)
    # enforce isolation
    keep = []
    for i in range(len(base_x)):
        if all((base_x[i] - base_x[j]) ** 2 + (base_y[i] - base_y[j]) ** 2 > 20 ** 2
               for j in keep):
            keep.append(i)
    base_x, base_y = base_x[keep], base_y[keep]
    flux = rng.uniform(20000, 90000, len(base_x))
    truths = []
    frames = []
    for i in range(n_frames):
        theta = rng.uniform(-0.02, 0.02) if i else 0.0
        tx, ty = (rng.uniform(-6, 6, 2)) if i else (0.0, 0.0)
        sx, sy = _apply_sim(base_x, base_y, 1.0, theta, tx, ty)
        img = np.full(shape, 200.0)
        for x, y, f in zip(sx, sy, flux):
            img += synth.gaussian_star(shape, x, y, f, 3.0)
        img = rng.poisson(np.clip(img, 0, None)).astype(np.float32)
        img += rng.normal(0, 5.0, shape).astype(np.float32)
        frames.append(img)
        truths.append((theta, tx, ty))
    return np.stack(frames), truths, (base_x, base_y, flux)


@pytest.mark.slow
def test_full_pipeline_registers_and_stacks():
    frames, truths, (bx, by, bf) = _make_dithered_stack()
    cfg = PipelineConfig(max_stars=32, match_k=12, detect_nsigma=7.0)
    stacked, diag = calibrate_register_stack(jnp.asarray(frames), config=cfg)
    stacked = np.asarray(stacked)
    # recovered transforms match the injected dithers
    for i, (theta, tx, ty) in enumerate(truths):
        assert float(diag["theta"][i]) == pytest.approx(theta, abs=3e-3), i
        assert float(diag["tx"][i]) == pytest.approx(tx, abs=0.3), i
        assert float(diag["ty"][i]) == pytest.approx(ty, abs=0.3), i
    # stars in the stack are at the reference positions and sharp
    from astrophotography_tpu.ops import find_stars, sigma_clipped_stats
    _, med, std = (float(v) for v in sigma_clipped_stats(stacked, sigma=3.0))
    stars = find_stars(stacked - med, fwhm=3.0, threshold=7.0 * std,
                       max_stars=64)
    v = np.asarray(stars.valid)
    dx, dy = np.asarray(stars.x)[v], np.asarray(stars.y)[v]
    matched = 0
    for x, y in zip(bx, by):
        d = np.hypot(dx - x, dy - y).min()
        if d < 1.0:
            matched += 1
    assert matched == len(bx)
    # noise in the stack is ~sqrt(N) lower than per-frame noise
    # (interior region: the few border pixels covered by no frame are 0)
    region = stacked[12:40, 12:40]
    assert np.std(region - np.median(region)) < 10.0


@pytest.mark.slow
def test_pipeline_auto_reference_frame():
    """ref_frame='auto' registers onto the frame with the most stars —
    a nearly starless frame 0 (e.g. clouds) no longer poisons the stack
    (the reference picks reference frames from the quality report)."""
    frames, truths, (bx, by, bf) = _make_dithered_stack()
    rng = np.random.default_rng(8)
    # ruin frame 0: pure noise, no stars
    frames = frames.copy()
    frames[0] = 200.0 + rng.normal(0, 5.0, frames[0].shape) \
        .astype(np.float32)

    cfg = PipelineConfig(max_stars=32, match_k=12, ref_frame="auto")
    stacked, diag = calibrate_register_stack(jnp.asarray(frames),
                                             config=cfg)
    ref_idx = int(diag["ref_frame"])
    assert ref_idx != 0
    # the auto reference frame maps with the identity
    assert float(diag["theta"][ref_idx]) == pytest.approx(0.0, abs=1e-6)
    assert float(diag["tx"][ref_idx]) == pytest.approx(0.0, abs=1e-6)
    # every good frame registered onto it with many inliers
    n_inl = np.asarray(diag["n_inliers"])
    assert (n_inl[1:] >= 8).all()
    # stars land at the reference frame's positions
    theta_r, tx_r, ty_r = truths[ref_idx]
    from astrophotography_tpu.ops import find_stars, sigma_clipped_stats
    s = np.asarray(stacked)
    _, med, std = (float(v) for v in sigma_clipped_stats(s, sigma=3.0))
    stars = find_stars(s - med, fwhm=3.0, threshold=7.0 * std,
                       max_stars=64)
    v = np.asarray(stars.valid)
    dx, dy = np.asarray(stars.x)[v], np.asarray(stars.y)[v]
    rx, ry = _apply_sim(bx, by, 1.0, theta_r, tx_r, ty_r)
    matched = sum(1 for x, y in zip(rx, ry)
                  if np.hypot(dx - x, dy - y).min() < 1.0)
    assert matched == len(bx)


@pytest.mark.slow
def test_pipeline_with_calibration_masters():
    frames, truths, _ = _make_dithered_stack(n_frames=4, seed=9)
    bias = np.full(frames.shape[1:], 300.0, np.float32)
    frames_raw = frames + bias[None]
    cfg = PipelineConfig(max_stars=32, match_k=10)
    stacked_cal, _ = calibrate_register_stack(
        jnp.asarray(frames_raw), bias=jnp.asarray(bias), config=cfg)
    stacked_ref, _ = calibrate_register_stack(jnp.asarray(frames), config=cfg)
    np.testing.assert_allclose(np.asarray(stacked_cal),
                               np.asarray(stacked_ref), atol=1e-2)


@pytest.mark.slow
def test_degenerate_registration_excludes_frame():
    """A frame whose registration finds < 2 inliers (e.g. one star)
    must come back as a far-translated unit transform — coverage then
    excludes it — never as a degenerate scale-0 matrix that maps the
    whole output to one in-range source point."""
    x = np.array([30.0] + [0.0] * 15, np.float32)
    y = np.array([40.0] + [0.0] * 15, np.float32)
    f = np.array([5000.0] + [0.0] * 15, np.float32)
    v = np.array([True] + [False] * 15)
    sim = estimate_similarity(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(f), jnp.asarray(v),
        jnp.asarray(x + 2.0), jnp.asarray(y), jnp.asarray(f),
        jnp.asarray(v), k=10)
    assert int(sim.n_inliers) < 2
    assert float(sim.scale) == 1.0
    assert abs(float(sim.tx)) > 1e6
    # the sentinel transform covers nothing
    from astrophotography_tpu.ops.warp import warp_affine_separable
    img = np.full((64, 64), 100.0, np.float32)
    out, cov = warp_affine_separable(jnp.asarray(img), sim.matrix(),
                                     (64, 64))
    assert float(jnp.max(cov)) == 0.0


def test_estimate_similarity_refines_on_every_matched_star():
    """The candidate search uses the k brightest stars, but the final
    refit matches every valid star: with 40 stars and k=8 all 40 are
    inliers, and their centroid noise averages down accordingly."""
    rng = np.random.default_rng(7)
    n = 40
    rx = rng.uniform(20, 1000, n)
    ry = rng.uniform(20, 1000, n)
    flux = rng.uniform(1000, 50000, n)
    theta, txy = 0.01, (3.3, -2.1)
    tx_s, ty_s = _apply_sim(rx, ry, 1.0, theta, *txy)
    noise = 0.1
    tx_s = tx_s + rng.normal(0, noise, n)
    ty_s = ty_s + rng.normal(0, noise, n)
    sim = estimate_similarity(*map(jnp.asarray, _star_table(rx, ry, flux)),
                              *map(jnp.asarray, _star_table(tx_s, ty_s, flux)),
                              k=8)
    assert int(sim.n_inliers) == n
    mx, my = _apply_sim(rx, ry, float(sim.scale), float(sim.theta),
                        float(sim.tx), float(sim.ty))
    tx0, ty0 = _apply_sim(rx, ry, 1.0, theta, *txy)
    err = np.sqrt(np.mean((mx - tx0) ** 2 + (my - ty0) ** 2))
    # a 4-parameter fit to m stars leaves noise * sqrt(4 / m) RMS at
    # the stars: 0.071 px from the 8 brightest, 0.032 px from all 40
    assert err < 0.05, err
