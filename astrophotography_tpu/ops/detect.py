"""DAOFIND-style star detection as fixed-capacity device ops.

Device-native equivalent of photutils.DAOStarFinder as used by the
reference (core/ApFindStars.py:299-340: DAOStarFinder(fwhm,
threshold=nsigma*bg_stddev) on background-subtracted data) plus the
saturation peak search (core/ApFindStars.py:866-876).

Algorithm (Stetson's DAOFIND, as in photutils):

1. convolve with a truncated, "lowered" Gaussian kernel whose
   normalization makes the convolution output the least-squares
   amplitude of a circular Gaussian + constant fit at each pixel
   (the "density" image);
2. local maxima of the density image above the threshold are
   candidate stars;
3. per-candidate image statistics: sharpness (central pixel vs
   footprint mean over density peak) and symmetry-based roundness;
4. centroid by iterated center-of-mass on the background-subtracted
   cutout.

Star counts are data-dependent, so results use the pad+mask+top-k
convention: arrays have static length ``max_stars``, with a boolean
``valid`` mask (SURVEY.md §7 "data-dependent shapes").
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .stencil import conv2d_static

FWHM_TO_SIGMA = 1.0 / 2.35482


class Stars(NamedTuple):
    """Fixed-capacity detected-star table (all arrays length max_stars)."""

    x: jnp.ndarray          # centroid column (0-based)
    y: jnp.ndarray          # centroid row (0-based)
    flux: jnp.ndarray       # density-image amplitude at the peak
    peak: jnp.ndarray       # peak pixel value (bg-subtracted data)
    sharpness: jnp.ndarray
    roundness: jnp.ndarray
    valid: jnp.ndarray      # bool

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid)


def _kernel_radius(fwhm: float) -> int:
    sigma = fwhm * FWHM_TO_SIGMA
    return max(2, int(round(1.5 * sigma * 2.35482 / 2)))


def daofind_kernel(fwhm: float) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """(kernel, footprint, radius): lowered Gaussian matched filter.

    Normalized so that convolution with data yields the least-squares
    amplitude of a Gaussian-plus-constant model at each position.
    """
    r = _kernel_radius(fwhm)
    sigma = fwhm * FWHM_TO_SIGMA
    # static host-side math (numpy): the kernel taps must be concrete
    # so the stencil convolution can elide zero taps at trace time
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    d2 = (xx ** 2 + yy ** 2).astype(np.float32)
    foot = (d2 <= r * r + r).astype(np.float32)  # DAOFIND circular footprint
    g = np.exp(-0.5 * d2 / sigma ** 2) * foot
    n = np.sum(foot)
    gsum = np.sum(g)
    gsq = np.sum(g * g)
    denom = gsq - gsum * gsum / n
    kernel = (g - (gsum / n)) * foot / denom
    return kernel.astype(np.float32), jnp.asarray(foot), r


def _conv2d_same(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """2-D correlation with zero padding via static shifted adds.

    For the small detection kernels (5x5 - 9x9) this lowers to pure
    elementwise work that XLA fuses into a handful of device-memory
    passes, with no im2col-style conv lowering for single-channel
    images.
    """
    import numpy as _np

    return conv2d_static(img, _np.asarray(kernel), pad_mode="zero")


def _conv_separable_same(img: jnp.ndarray, col: jnp.ndarray,
                         row: jnp.ndarray) -> jnp.ndarray:
    """Separable correlation (rank-1 kernel col x row), zero padded.

    Two 1-D tap loops instead of kh*kw 2-D taps; the column pass runs
    first so the column-shifted (expensive) row pass touches the already
    reduced intermediate once."""
    kh, kw = col.shape[0], row.shape[0]
    h, w = img.shape
    padr = jnp.pad(img, ((kh // 2, kh // 2), (0, 0)))
    t = jnp.zeros_like(img)
    for dy in range(kh):
        t = t + col[dy] * padr[dy:dy + h, :]
    padc = jnp.pad(t, ((0, 0), (kw // 2, kw // 2)))
    out = jnp.zeros_like(img)
    for dx in range(kw):
        out = out + row[dx] * padc[:, dx:dx + w]
    return out


def _fast_density(data: jnp.ndarray, fwhm: float,
                  row_sigma_scale: float = 1.0) -> jnp.ndarray:
    """Registration-grade DAOFIND density: square footprint + bf16.

    With the footprint widened from DAOFIND's circle to the full
    (2r+1)^2 square, the lowered-Gaussian matched filter is EXACTLY
    rank 2 — a separable Gaussian minus a constant times a separable
    box sum — so the 25-tap 2-D conv becomes four 5-tap 1-D passes.
    Computed in bfloat16 (the density only feeds a relative threshold
    and peak ranking; amplitude rounding is ~0.5%).  Differences from
    the exact kernel: the 4 corner pixels (Gaussian weight < 0.09)
    join the footprint, and bf16 rounding — bounded by
    tests/test_detect.py::test_fast_mode_matches_exact_on_bright_stars.
    """
    r = _kernel_radius(fwhm)
    sigma = fwhm * FWHM_TO_SIGMA
    d = np.arange(-r, r + 1, dtype=np.float32)
    gc = np.exp(-0.5 * d * d / sigma ** 2)
    # row axis may be 2x-binned: the PSF is row_sigma_scale as wide there
    gr = np.exp(-0.5 * d * d / (sigma * row_sigma_scale) ** 2)
    n = float((2 * r + 1) ** 2)
    gsum = float(np.sum(gr)) * float(np.sum(gc))
    gsq = float(np.sum(gr * gr)) * float(np.sum(gc * gc))
    denom = gsq - gsum * gsum / n
    xb = data.astype(jnp.bfloat16)
    grb = jnp.asarray(gr, jnp.bfloat16)
    gcb = jnp.asarray(gc, jnp.bfloat16)
    ones = jnp.ones_like(gcb)
    gconv = _conv_separable_same(xb, grb, gcb)
    box = _conv_separable_same(xb, ones, ones)
    # stay in bf16: the downstream peak search runs on the density at
    # half the HBM traffic; values are only promoted per peak
    return ((gconv - jnp.bfloat16(gsum / n) * box)
            * jnp.bfloat16(1.0 / denom))


@functools.partial(jax.jit, static_argnames=("fwhm", "max_stars", "border",
                                              "topk_mode", "mode", "stats",
                                              "bin_rows"))
def find_stars(
    data: jnp.ndarray,
    fwhm: float = 3.0,
    threshold: float = 100.0,
    max_stars: int = 1024,
    mask: Optional[jnp.ndarray] = None,
    border: int = 2,
    topk_mode: str = "global",
    mode: str = "exact",
    stats: bool = True,
    bin_rows: bool = False,
    floor: "jnp.ndarray | float" = 0.0,
) -> Stars:
    """Detect star-like sources in background-subtracted data.

    ``floor``: scalar background level to subtract ONLY where the
    offset matters (centroid cutouts, peak values).  The matched
    filter has zero DC response, so passing the un-subtracted frame
    with ``floor=center`` is numerically identical to passing
    ``frame - center`` — without materializing the subtracted copy
    (saves a full f32 stack write+read per detection chunk).

    ``threshold`` is in amplitude (density) units — pass
    ``nsigma * bg_stddev`` to match the reference invocation
    (core/ApFindStars.py:305-309).  ``mask`` True = excluded pixel.

    ``topk_mode``: 'global' ranks every peak exactly;  'tile' keeps
    only the strongest peak per 64x256 tile before ranking — a
    per-tile max reduction in place of a full-image top_k, and
    registration-grade fields (tens of stars per frame) lose at most
    the occasional same-tile neighbor.

    ``mode``: 'exact' = DAOFIND circular-footprint f32 matched filter;
    'fast' = separable square-footprint bf16 filter (fewer taps at
    half the bytes; registration-grade — see :func:`_fast_density`); the bf16
    density also halves the peak-search HBM traffic.

    ``stats=False`` skips the per-star sharpness/roundness/peak-value
    statistics (zeros returned) — registration only needs x/y/flux.

    ``bin_rows`` (fast mode, stats=False only): run the density and
    peak search on 2x row-binned data (row binning keeps the
    contiguous column axis untouched) — halves the detection
    cost.  Peak rows map back x2 and the full-resolution
    center-of-mass centroid restores subpixel accuracy.
    """
    data = data.astype(jnp.float32)
    floor_f = jnp.asarray(floor, jnp.float32)
    h, w = data.shape
    kernel, foot, r = daofind_kernel(fwhm)
    bin_r = 2 if (bin_rows and mode == "fast" and h % 2 == 0) else 1
    if bin_r > 1:
        if stats:
            raise ValueError("bin_rows requires stats=False (the "
                             "binned density has no per-star statistics)")
        det = 0.5 * (data[0::2, :] + data[1::2, :])
        dens = _fast_density(det, fwhm, row_sigma_scale=0.5)
    elif mode == "fast":
        dens = _fast_density(data, fwhm)
    else:
        dens = _conv2d_same(data, kernel)
    hd = h // bin_r
    if mask is not None:
        mask_d = (mask[0::2, :] | mask[1::2, :]) if bin_r > 1 else mask
        dens = jnp.where(mask_d, -jnp.inf, dens).astype(dens.dtype)
    thr = jnp.asarray(threshold, dens.dtype)

    # local maxima over a 3x3 neighborhood, above threshold, off borders.
    # Plateau tie-break: strict > against raster-earlier neighbors,
    # >= against later ones, so a flat 2-pixel peak (bf16 quantization
    # in fast mode can produce exact ties) yields exactly one detection
    # instead of zero.
    pad = jnp.pad(dens, 1, constant_values=-jnp.inf)
    nm_earlier = jnp.full_like(dens, -jnp.inf)
    nm_later = jnp.full_like(dens, -jnp.inf)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            shifted = pad[dy:dy + hd, dx:dx + w]
            if dy * 3 + dx < 4:  # before the center in raster order
                nm_earlier = jnp.maximum(nm_earlier, shifted)
            else:
                nm_later = jnp.maximum(nm_later, shifted)
    rows = jnp.arange(hd)[:, None]
    cols = jnp.arange(w)[None, :]
    bmask = ((rows >= (border + r + bin_r - 1) // bin_r)
             & (rows < hd - (border + r + bin_r - 1) // bin_r)
             & (cols >= border + r) & (cols < w - border - r))
    is_peak = ((dens > nm_earlier) & (dens >= nm_later)
               & (dens > thr) & bmask)

    score = jnp.where(is_peak, dens, -jnp.inf)
    tth, ttw = 64 // bin_r, 256
    if (topk_mode == "tile" and hd % tth == 0 and w % ttw == 0
            and (hd // tth) * (w // ttw) >= max_stars):
        # strongest peak per (64, 256) tile, then a tiny cross-tile
        # top_k.  The within-tile argmax is recovered with iota-select
        # (reductions over axes 1 and 3 of the reshape — no strided
        # slices, no gathers).
        s4 = score.reshape(hd // tth, tth, w // ttw, ttw)
        m = jnp.max(s4, axis=(1, 3))
        ly = jax.lax.broadcasted_iota(jnp.int32, s4.shape, 1)
        lx = jax.lax.broadcasted_iota(jnp.int32, s4.shape, 3)
        hit = s4 == m[:, None, :, None]
        enc = jnp.where(hit, ly * ttw + lx, jnp.int32(2 ** 30))
        loc = jnp.min(enc, axis=(1, 3))
        top_vals, tidx = jax.lax.top_k(m.reshape(-1), max_stars)
        top_vals = top_vals.astype(jnp.float32)
        valid = jnp.isfinite(top_vals)
        ntj = w // ttw
        l = jnp.take(loc.reshape(-1), tidx)
        py = ((tidx // ntj) * tth + l // ttw) * bin_r
        px = (tidx % ntj) * ttw + l % ttw
    elif hd % 2 == 0:
        # two vertically adjacent strict 3x3 maxima are impossible, so a
        # pairwise row max halves the top_k input without losing any
        # candidate.  Only the row axis is strided, so the contiguous
        # column axis keeps its full-width reads.
        r0 = score[0::2, :]
        r1 = score[1::2, :]
        bmax = jnp.maximum(r0, r1)
        from_r1 = (r1 > r0).astype(jnp.int32)
        top_vals, bidx = jax.lax.top_k(bmax.reshape(-1), max_stars)
        top_vals = top_vals.astype(jnp.float32)
        valid = jnp.isfinite(top_vals)
        py = ((bidx // w) * 2 + jnp.take(from_r1.reshape(-1), bidx)) * bin_r
        px = bidx % w
    else:
        top_vals, top_idx = jax.lax.top_k(score.reshape(-1), max_stars)
        top_vals = top_vals.astype(jnp.float32)
        valid = jnp.isfinite(top_vals)
        py = (top_idx // w) * bin_r
        px = top_idx % w

    if bin_r > 1:
        # the binned peak row is only even-resolved; pick the brighter
        # of the two full-resolution candidates so the centroid box is
        # centered (a tiny per-detection gather, not a per-pixel one)
        py_alt = jnp.clip(py + 1, 0, h - 1)
        py = jnp.where(data[py_alt, px] > data[py, px], py_alt, py)

    box = 2 * r + 1

    def per_star(cy, cx):
        y0 = jnp.clip(cy - r, 0, h - box)
        x0 = jnp.clip(cx - r, 0, w - box)
        cut = jax.lax.dynamic_slice(data, (y0, x0), (box, box))
        if stats:
            # sharpness: (peak pixel - footprint mean excl. center) /
            # density — the difference is floor-invariant, so compute
            # it on the raw values; only the REPORTED peak subtracts
            center_raw = data[cy, cx]
            foot_n = jnp.sum(foot) - 1.0
            foot_mean = (jnp.sum(cut * foot) - center_raw) / foot_n
            dens_peak = dens[cy, cx].astype(jnp.float32)
            sharp = (center_raw - foot_mean) / jnp.maximum(dens_peak, 1e-12)
            center = center_raw - floor_f
            # roundness: asymmetry of 4-fold symmetric sum of the density
            dcut = jax.lax.dynamic_slice(dens, (y0, x0), (box, box)) \
                .astype(jnp.float32)
            sym2 = dcut + dcut[::-1, ::-1]
            hx = jnp.sum(sym2, axis=0)
            hy = jnp.sum(sym2, axis=1)
            sx = jnp.sum(jnp.abs(hx - hx[::-1]))
            sy = jnp.sum(jnp.abs(hy - hy[::-1]))
            tot = jnp.sum(jnp.abs(sym2)) + 1e-12
            roundness = (sx - sy) / tot
        else:
            center = jnp.float32(0.0)
            sharp = jnp.float32(0.0)
            roundness = jnp.float32(0.0)
        # iterated center of mass on positive data within the box
        pos = jnp.maximum(cut - floor_f, 0.0)
        ys = jnp.arange(box, dtype=jnp.float32)
        xs = jnp.arange(box, dtype=jnp.float32)
        wsum = jnp.maximum(jnp.sum(pos), 1e-12)
        cy_f = jnp.sum(pos * ys[:, None]) / wsum + y0
        cx_f = jnp.sum(pos * xs[None, :]) / wsum + x0
        return cx_f, cy_f, center, sharp, roundness

    cx_f, cy_f, peaks, sharps, rounds = jax.vmap(per_star)(py, px)
    zero = jnp.zeros(max_stars, jnp.float32)
    return Stars(
        x=jnp.where(valid, cx_f, zero),
        y=jnp.where(valid, cy_f, zero),
        flux=jnp.where(valid, top_vals, zero),
        peak=jnp.where(valid, peaks, zero),
        sharpness=jnp.where(valid, sharps, zero),
        roundness=jnp.where(valid, rounds, zero),
        valid=valid,
    )


@functools.partial(jax.jit, static_argnames=("max_peaks", "box"))
def find_saturated(
    data: jnp.ndarray,
    sat_thresh: float,
    max_peaks: int = 256,
    box: int = 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Local maxima above the saturation threshold
    (reference _find_saturated, core/ApFindStars.py:866-876).

    Returns (x, y, valid) fixed-capacity arrays.
    """
    data = data.astype(jnp.float32)
    h, w = data.shape
    half = box // 2
    pad = jnp.pad(data, half, constant_values=-jnp.inf)
    neigh_max = jnp.full_like(data, -jnp.inf)
    for dy in range(box):
        for dx in range(box):
            if dy == half and dx == half:
                continue
            neigh_max = jnp.maximum(neigh_max, pad[dy:dy + h, dx:dx + w])
    is_peak = (data >= neigh_max) & (data > sat_thresh)
    score = jnp.where(is_peak, data, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(score, max_peaks)
    valid = jnp.isfinite(vals)
    return (idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32), valid


def mask_boxes(
    shape: Tuple[int, int],
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    valid: jnp.ndarray,
    half_width: int,
) -> jnp.ndarray:
    """Boolean mask with a (2*half_width+1)² box set around each point
    (reference saturated-star box masking, core/ApFindStars.py:165-189)."""
    h, w = shape
    rows = jnp.arange(h)[:, None, None]
    cols = jnp.arange(w)[None, :, None]
    inside = ((jnp.abs(rows - ys[None, None, :]) <= half_width)
              & (jnp.abs(cols - xs[None, None, :]) <= half_width)
              & valid[None, None, :])
    return jnp.any(inside, axis=-1)
