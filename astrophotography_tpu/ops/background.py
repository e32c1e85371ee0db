"""Large-scale 2-D sky background modelling.

Device-native equivalent of photutils.Background2D as configured by the
reference ApMeasureBackground (core/ApMeasureBackground.py:332-417:
coarse box grid, per-box sigma-clipped median with source-masked pixels
excluded, exclude_percentile guard, median filter over the box grid,
then upsampling to full resolution), plus the segmentation-style source
mask built from sigma-clipped thresholding + binary dilation
(reference _make_source_mask, :142-172).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .stats import masked_median, sigma_clip_mask, sigma_clipped_stats


def _bspline3(s: np.ndarray) -> np.ndarray:
    """Cubic B-spline kernel values (support |s| < 2)."""
    s = np.abs(np.asarray(s, np.float64))
    return np.where(s < 1.0, 2.0 / 3.0 - s * s + 0.5 * s ** 3,
                    np.where(s < 2.0, (2.0 - s) ** 3 / 6.0, 0.0))


def _reflect_idx(p: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect'/'grid-mirror' index extension:
    (d c b a | a b c d | d c b a)."""
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n
    p = np.mod(p, period)
    return np.where(p >= n, period - 1 - p, p)


@functools.lru_cache(maxsize=64)
def _spline_zoom_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix realizing scipy.ndimage.zoom's 1-D
    order-3 spline zoom with mode='reflect', grid_mode=True — exactly
    (value-asserted against scipy in tests).  The separable 2-D zoom is
    then two small static matmuls (My @ grid @ Mx.T), the device-friendly
    form of photutils' BkgZoomInterpolator (the reference's Background2D
    upsampler, core/ApMeasureBackground.py:404-410).

    Construction: the cubic-spline prefilter is the inverse of the
    B-spline collocation matrix (rows: 1/6, 4/6, 1/6 with reflect
    boundary folding) and the evaluation matrix carries the B-spline
    weights at the zoomed grid-center coordinates
    x = (i + 0.5) * n_in / n_out - 0.5."""
    coll = np.zeros((n_in, n_in))
    for i in range(n_in):
        for off, wgt in ((-1, 1.0 / 6.0), (0, 4.0 / 6.0), (1, 1.0 / 6.0)):
            j = int(_reflect_idx(np.asarray(i + off), n_in))
            coll[i, j] += wgt
    prefilter = np.linalg.inv(coll)
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    base = np.floor(x).astype(int)
    ev = np.zeros((n_out, n_in))
    for k in range(-1, 3):
        idx = base + k
        w = _bspline3(x - idx)
        j = _reflect_idx(idx, n_in)
        for i in range(n_out):
            ev[i, int(j[i])] += w[i]
    return ev @ prefilter


@functools.partial(jax.jit, static_argnames=("nsigma", "npixels", "dilate"))
def source_mask(
    data: jnp.ndarray,
    nsigma: float = 3.0,
    npixels: int = 5,
    dilate: int = 11,
) -> jnp.ndarray:
    """Boolean mask of source-contaminated pixels.

    Approximates photutils detect_threshold/detect_sources/
    make_source_mask (reference core/ApFindStars.py:146-153 with
    size=11, core/ApMeasureBackground.py:142-172 with size=13):
    threshold at median + nsigma*std (sigma-clipped), require a local
    neighborhood of >= npixels above-threshold pixels (connectivity
    proxy for the minimum source size), then dilate by a square kernel.
    """
    _, med, std = sigma_clipped_stats(data, sigma=3.0)
    above = data > (med + nsigma * std)
    # npixels proxy: count of above-threshold pixels in a 3x3 neighborhood
    h, w = data.shape
    pad = jnp.pad(above.astype(jnp.float32), 1)
    count = jnp.zeros_like(data)
    for dy in range(3):
        for dx in range(3):
            count = count + pad[dy:dy + h, dx:dx + w]
    seed = above & (count >= min(npixels, 9))
    # binary dilation with a (dilate x dilate) square
    half = dilate // 2
    padded = jnp.pad(seed, half)
    out = jnp.zeros_like(seed)
    for dy in range(dilate):
        for dx in range(dilate):
            out = out | padded[dy:dy + h, dx:dx + w]
    return out


@functools.partial(
    jax.jit,
    static_argnames=("nboxes_y", "nboxes_x", "filter_size", "sigma",
                     "exclude_percentile", "upsample"))
def background2d(
    data: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    nboxes_y: int = 16,
    nboxes_x: int = 16,
    filter_size: int = 3,
    sigma: float = 3.0,
    exclude_percentile: float = 25.0,
    upsample: str = "bilinear",
) -> jnp.ndarray:
    """Full-resolution background model from a coarse box grid.

    Per box: sigma-clipped median of unmasked pixels; boxes whose
    masked fraction exceeds (100 - exclude_percentile)% are interpolated
    from the filtered grid (reference exclude-percentile semantics,
    core/ApMeasureBackground.py:404-410).  The grid is smoothed with a
    (filter_size x filter_size) median filter and upsampled to full
    resolution: ``upsample='bilinear'`` (fast path — one pass over the
    output) or ``'spline'`` (order-3 B-spline zoom, exactly photutils'
    BkgZoomInterpolator/scipy grid-mode zoom semantics, realized as two
    static matmuls; the reference's engine,
    core/ApMeasureBackground.py:404-410).

    The image must be evenly divisible by the box grid; the host layer
    pads/crops to a valid geometry (reference _set_bgbox_size rounds box
    sizes similarly, core/ApMeasureBackground.py:255-330).
    """
    if upsample not in ("bilinear", "spline"):
        raise ValueError(f"unknown upsample '{upsample}'")
    data = data.astype(jnp.float32)
    h, w = data.shape
    if h % nboxes_y or w % nboxes_x:
        raise ValueError(
            f"image {h}x{w} not divisible by box grid {nboxes_y}x{nboxes_x}")
    by, bx = h // nboxes_y, w // nboxes_x
    boxes = data.reshape(nboxes_y, by, nboxes_x, bx).transpose(0, 2, 1, 3)
    boxes = boxes.reshape(nboxes_y, nboxes_x, by * bx)
    good = jnp.ones_like(boxes, bool) if mask is None else \
        (~mask).reshape(nboxes_y, by, nboxes_x, bx).transpose(0, 2, 1, 3) \
        .reshape(nboxes_y, nboxes_x, by * bx)

    keep = sigma_clip_mask(boxes, good, sigma_lower=sigma, sigma_upper=sigma,
                           maxiters=5, axis=2)
    box_med = masked_median(boxes, keep, axis=2)
    good_frac = jnp.mean(good.astype(jnp.float32), axis=2)
    ok = good_frac >= (exclude_percentile / 100.0)
    # fill rejected boxes with the median of accepted boxes
    global_fill = masked_median(box_med.reshape(-1), ok.reshape(-1))
    box_med = jnp.where(ok, box_med, global_fill)

    # median filter over the box grid (reference filter_size default 3)
    half = filter_size // 2
    padded = jnp.pad(box_med, half, mode="edge")
    stack = jnp.stack([
        padded[dy:dy + nboxes_y, dx:dx + nboxes_x]
        for dy in range(filter_size) for dx in range(filter_size)], axis=0)
    box_med = jnp.median(stack, axis=0)

    if upsample == "spline":
        my = jnp.asarray(_spline_zoom_matrix(nboxes_y, h), jnp.float32)
        mx = jnp.asarray(_spline_zoom_matrix(nboxes_x, w), jnp.float32)
        # full f32 products: the zoom is pinned to scipy, and a
        # reduced-precision matmul (TF32) keeps only ~3 decimal digits
        hi = jax.lax.Precision.HIGHEST
        return jnp.matmul(jnp.matmul(my, box_med, precision=hi), mx.T,
                          precision=hi)

    # bilinear upsample box centers -> full resolution
    yc = (jnp.arange(h, dtype=jnp.float32) - (by - 1) / 2.0) / by
    xc = (jnp.arange(w, dtype=jnp.float32) - (bx - 1) / 2.0) / bx
    y0 = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, nboxes_y - 1)
    x0 = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, nboxes_x - 1)
    y1 = jnp.clip(y0 + 1, 0, nboxes_y - 1)
    x1 = jnp.clip(x0 + 1, 0, nboxes_x - 1)
    fy = jnp.clip(yc - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(xc - x0, 0.0, 1.0)[None, :]
    g00 = box_med[jnp.ix_(y0, x0)]
    g01 = box_med[jnp.ix_(y0, x1)]
    g10 = box_med[jnp.ix_(y1, x0)]
    g11 = box_med[jnp.ix_(y1, x1)]
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)
