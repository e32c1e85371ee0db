"""Fused RAW mosaic -> RGB/grey conversion kernels.

Device-native replacement for the LibRaw ``postprocess`` call the
reference makes for every conversion (reference core/RawConv.py:453-455:
linear gamma, no auto-bright/scale, 16-bit output, user white balance).
The whole chain — per-site black-level subtraction with the uint16
wraparound guard (reference ``_safe_subtract`` core/RawConv.py:250-289),
white-balance multiplication, 16-bit range scaling, bilinear demosaic,
CCIR-601 luma, and percentile renormalization (core/RawConv.py:462-471)
— is a single jitted computation that XLA fuses into one pass over the
mosaic.

Demosaic algorithms:

* ``mhc`` (default) — Malvar-He-Cutler gradient-corrected linear
  interpolation (Malvar, He & Cutler, ICASSP 2004): five fixed 5x5
  filters over the CFA signal, selected per site class.  Quality is
  AHD-class on edges (the reference inherits LibRaw's AHD via
  postprocess, core/RawConv.py:453-455) while staying a pure
  fixed-stencil convolution — elementwise device work, no
  data-dependent control flow.
* ``bilinear`` — mask-normalized bilinear interpolation, pattern
  agnostic; kept as the fallback for exotic CFA layouts.
* ``ahd`` — adaptive homogeneity-directed (Hirakawa & Parks 2005), the
  algorithm LibRaw itself runs for the reference's postprocess call;
  directional interpolation + homogeneity selection, for
  parity-critical use (~4x the cost of mhc).

Both formulations only need the per-pixel color map (the analogue of
rawpy's ``raw_colors_visible``); MHC additionally derives the site
classes (green-in-red-row vs green-in-blue-row) from the map itself,
so every Bayer phase (RGGB/BGGR/GRBG/GBRG) works unchanged.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .stencil import conv2d_static

#: CCIR 601 luma coefficients (reference core/RawConv.py:550).
CCIR601 = (0.299, 0.587, 0.114)

#: color plane indices (reference RawConv class attrs R/G1/B/G2).
R, G1, B, G2 = 0, 1, 2, 3

MAX_ADU = 65535.0


def _conv3x3_sum(x: jnp.ndarray, kernel) -> jnp.ndarray:
    """3x3 weighted sum via shifted adds (elementwise, no gathers).

    ``kernel`` is a static Python 3x3 nested sequence so zero taps are
    elided at trace time.
    """
    h, w = x.shape
    padded = jnp.pad(x, 1)
    out = jnp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            k = float(kernel[dy][dx])
            if k != 0.0:
                out = out + k * padded[dy:dy + h, dx:dx + w]
    return out


_BILINEAR_KERNEL = (
    (0.25, 0.5, 0.25),
    (0.5, 1.0, 0.5),
    (0.25, 0.5, 0.25),
)


@jax.jit
def demosaic_bilinear(values: jnp.ndarray, color_map: jnp.ndarray) -> jnp.ndarray:
    """Mask-normalized bilinear demosaic: (H, W) sites -> (H, W, 3) RGB.

    For each output color c, interpolate from the sites of that color
    with a 3x3 tent kernel, normalizing by the convolved site mask so
    edges and every CFA layout are handled uniformly.
    """
    values = values.astype(jnp.float32)
    planes = []
    for colors in ((R,), (G1, G2), (B,)):
        site = jnp.zeros_like(values, dtype=jnp.bool_)
        for c in colors:
            site = site | (color_map == c)
        sitef = site.astype(jnp.float32)
        num = _conv3x3_sum(values * sitef, _BILINEAR_KERNEL)
        den = _conv3x3_sum(sitef, _BILINEAR_KERNEL)
        interp = num / jnp.maximum(den, 1e-12)
        # measured sites keep their own sample exactly (classical bilinear)
        planes.append(jnp.where(site, values, interp))
    return jnp.stack(planes, axis=-1)


def _conv5x5_sum(x: jnp.ndarray, kernel) -> jnp.ndarray:
    """5x5 weighted sum, reflect-padded (see ops/stencil.py)."""
    return conv2d_static(x, kernel, pad_mode="reflect")


# Malvar-He-Cutler 2004 filters, in eighths.  Names by target:
# G at an R/B site; R/B at a green site whose same-color neighbors are
# horizontal (row) or vertical (col); R at a B site / B at an R site
# (diag).
_E = 1.0 / 8.0
_MHC_G_AT_RB = (
    (0, 0, -1 * _E, 0, 0),
    (0, 0, 2 * _E, 0, 0),
    (-1 * _E, 2 * _E, 4 * _E, 2 * _E, -1 * _E),
    (0, 0, 2 * _E, 0, 0),
    (0, 0, -1 * _E, 0, 0),
)
_MHC_RB_ROW = (
    (0, 0, 0.5 * _E, 0, 0),
    (0, -1 * _E, 0, -1 * _E, 0),
    (-1 * _E, 4 * _E, 5 * _E, 4 * _E, -1 * _E),
    (0, -1 * _E, 0, -1 * _E, 0),
    (0, 0, 0.5 * _E, 0, 0),
)
_MHC_RB_COL = tuple(zip(*_MHC_RB_ROW))  # transpose
_MHC_RB_DIAG = (
    (0, 0, -1.5 * _E, 0, 0),
    (0, 2 * _E, 0, 2 * _E, 0),
    (-1.5 * _E, 0, 6 * _E, 0, -1.5 * _E),
    (0, 2 * _E, 0, 2 * _E, 0),
    (0, 0, -1.5 * _E, 0, 0),
)


def _horizontal_neighbor_mask(site: jnp.ndarray) -> jnp.ndarray:
    """True where a horizontal (left or right) neighbor is in ``site``.

    Wrap padding preserves Bayer phase (H, W are even for every CFA),
    so edge columns classify correctly.
    """
    padded = jnp.pad(site, ((0, 0), (1, 1)), mode="wrap")
    return padded[:, :-2] | padded[:, 2:]


@jax.jit
def demosaic_mhc(values: jnp.ndarray, color_map: jnp.ndarray) -> jnp.ndarray:
    """Malvar-He-Cutler demosaic: (H, W) CFA sites -> (H, W, 3) RGB.

    Gradient-corrected bilinear interpolation: each missing color is a
    fixed 5x5 linear filter of the raw CFA signal (the filters embed
    the luminance-gradient correction), selected by the site's class.
    Measured sites keep their own sample exactly.
    """
    v = values.astype(jnp.float32)
    site_r = color_map == R
    site_b = color_map == B
    site_g = (color_map == G1) | (color_map == G2)
    # green sites split by the orientation of their red neighbors
    g_red_row = site_g & _horizontal_neighbor_mask(site_r)
    g_blue_row = site_g & _horizontal_neighbor_mask(site_b)

    conv_g = _conv5x5_sum(v, _MHC_G_AT_RB)
    conv_row = _conv5x5_sum(v, _MHC_RB_ROW)
    conv_col = _conv5x5_sum(v, _MHC_RB_COL)
    conv_diag = _conv5x5_sum(v, _MHC_RB_DIAG)

    red = jnp.where(site_r, v,
                    jnp.where(g_red_row, conv_row,
                              jnp.where(g_blue_row, conv_col, conv_diag)))
    green = jnp.where(site_g, v, conv_g)
    blue = jnp.where(site_b, v,
                     jnp.where(g_blue_row, conv_row,
                               jnp.where(g_red_row, conv_col, conv_diag)))
    return jnp.stack([red, green, blue], axis=-1)


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """x translated by (dy, dx), wrap-padded (no gathers).

    Wrap keeps the Bayer COLOR PHASE intact at the borders (H, W are
    even for every CFA): an edge-replicated pad would feed wrong-color
    samples into the directional filters, corrupting the outermost two
    columns/rows far worse than the spatially-wrong-but-right-color
    wrap samples do."""
    return jnp.roll(x, (dy, dx), axis=(0, 1))


@jax.jit
def demosaic_ahd(values: jnp.ndarray, color_map: jnp.ndarray) -> jnp.ndarray:
    """Adaptive Homogeneity-Directed demosaic (Hirakawa & Parks 2005):
    (H, W) CFA sites -> (H, W, 3) RGB.

    The algorithm LibRaw runs for the reference's ``postprocess`` call
    (core/RawConv.py:453-455, dcraw ahd_interpolate): green is
    interpolated twice (horizontal and vertical directional filters
    with Laplacian correction), chroma rides the interpolated
    color-difference planes, and each pixel picks the direction whose
    3x3-smoothed homogeneity (neighbors within adaptive luma/chroma
    tolerance) is higher — averaging where tied.  This build scores
    homogeneity in luma/color-difference space rather than CIELab
    (monotone in the same differences; saves the per-pixel cube roots)
    and is pattern-generic via the color map.  Pure stencils and
    selects — no data-dependent control flow, so XLA fuses the whole
    thing; ~4x the cost of ``mhc``, for parity-critical use.
    """
    v = values.astype(jnp.float32)
    site_r = color_map == R
    site_b = color_map == B
    site_g = (color_map == G1) | (color_map == G2)

    # directional green at non-green sites: average of the two in-line
    # greens plus a half Laplacian of the same-color in-line samples
    gh = 0.5 * (_shift(v, 0, -1) + _shift(v, 0, 1)) \
        + 0.25 * (2.0 * v - _shift(v, 0, -2) - _shift(v, 0, 2))
    gv = 0.5 * (_shift(v, -1, 0) + _shift(v, 1, 0)) \
        + 0.25 * (2.0 * v - _shift(v, -2, 0) - _shift(v, 2, 0))
    greens = [jnp.where(site_g, v, gh), jnp.where(site_g, v, gv)]

    cands = []
    for g in greens:
        # chroma via mask-normalized bilinear of the color DIFFERENCE
        # planes (R-G, B-G known at their sites), then add green back
        planes = [g]
        for site in (site_r, site_b):
            sitef = site.astype(jnp.float32)
            diff = jnp.where(site, v - g, 0.0)
            num = _conv3x3_sum(diff, _BILINEAR_KERNEL)
            den = _conv3x3_sum(sitef, _BILINEAR_KERNEL)
            plane = g + num / jnp.maximum(den, 1e-12)
            planes.append(jnp.where(site, v, plane))
        cands.append(jnp.stack([planes[1], planes[0], planes[2]], axis=-1))

    # homogeneity maps: neighbors within adaptive luma/chroma tolerance
    def luma_chroma(c):
        lum = 0.25 * (c[..., 0] + 2.0 * c[..., 1] + c[..., 2])
        return lum, c[..., 0] - c[..., 1], c[..., 2] - c[..., 1]

    lh, uh, wh_ = luma_chroma(cands[0])
    lv, uv, wv = luma_chroma(cands[1])
    nbrs = ((0, -1), (0, 1), (-1, 0), (1, 0))

    def diffs(lum, u, w):
        dl = [jnp.abs(lum - _shift(lum, dy, dx)) for dy, dx in nbrs]
        dc = [(u - _shift(u, dy, dx)) ** 2 + (w - _shift(w, dy, dx)) ** 2
              for dy, dx in nbrs]
        return dl, dc

    dlh, dch = diffs(lh, uh, wh_)
    dlv, dcv = diffs(lv, uv, wv)
    # adaptive tolerance: the smaller of each direction's own in-line
    # neighbor spread (dcraw ahd epsilon)
    eps_l = jnp.minimum(jnp.maximum(dlh[0], dlh[1]),
                        jnp.maximum(dlv[2], dlv[3]))
    eps_c = jnp.minimum(jnp.maximum(dch[0], dch[1]),
                        jnp.maximum(dcv[2], dcv[3]))
    hom_h = functools.reduce(jnp.add, [
        ((dl <= eps_l) & (dc <= eps_c)).astype(jnp.float32)
        for dl, dc in zip(dlh, dch)])
    hom_v = functools.reduce(jnp.add, [
        ((dl <= eps_l) & (dc <= eps_c)).astype(jnp.float32)
        for dl, dc in zip(dlv, dcv)])
    box = ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    sh = _conv3x3_sum(hom_h, box)
    sv = _conv3x3_sum(hom_v, box)
    pick_h = (sh > sv)[..., None]
    pick_v = (sv > sh)[..., None]
    blend = 0.5 * (cands[0] + cands[1])
    return jnp.where(pick_h, cands[0], jnp.where(pick_v, cands[1], blend))


_DEMOSAIC_FUNCS = {"mhc": demosaic_mhc, "bilinear": demosaic_bilinear,
                   "ahd": demosaic_ahd}


def safe_subtract_black(
    mosaic: jnp.ndarray,
    color_map: jnp.ndarray,
    black_levels: jnp.ndarray,
) -> jnp.ndarray:
    """Per-site black-level subtraction clamped at zero.

    The reference resets pixels below the black level to the black
    level before subtracting so uint16 cannot wrap (reference
    core/RawConv.py:269-289); in float that is exactly
    ``max(x - black, 0)``.
    """
    bl = black_levels.astype(jnp.float32)[color_map]
    return jnp.maximum(mosaic.astype(jnp.float32) - bl, 0.0)


@functools.partial(jax.jit, static_argnames=("subtract_black", "algorithm"))
def raw_to_rgb(
    mosaic: jnp.ndarray,
    color_map: jnp.ndarray,
    black_levels: jnp.ndarray,
    wb: jnp.ndarray,
    white_level: float = 65535.0,
    subtract_black: bool = True,
    algorithm: str = "mhc",
) -> jnp.ndarray:
    """Linear 16-bit-range RGB from a uint16 Bayer mosaic.

    Equivalent of LibRaw postprocess(gamma=(1,1), no_auto_bright,
    output_bps=16, user_wb): black subtraction, white-balance
    multipliers applied at the CFA sites, scaling so the sensor range
    [black, white_level] maps to [0, 65535], then demosaic
    (``algorithm``: 'mhc' gradient-corrected default, or 'bilinear').
    Output float32 (caller clips/casts; reference clips at
    core/RawConv.py:484-486).
    """
    if algorithm not in _DEMOSAIC_FUNCS:
        raise ValueError(f"unknown demosaic algorithm {algorithm!r}; "
                         f"choose from {sorted(_DEMOSAIC_FUNCS)}")
    f = mosaic.astype(jnp.float32)
    if subtract_black:
        f = safe_subtract_black(f, color_map, black_levels)
        ref_black = jnp.max(black_levels.astype(jnp.float32))
    else:
        ref_black = jnp.float32(0.0)
    f = f * wb.astype(jnp.float32)[color_map]
    scale = MAX_ADU / jnp.maximum(jnp.float32(white_level) - ref_black, 1.0)
    f = f * scale
    return _DEMOSAIC_FUNCS[algorithm](f, color_map)


@functools.partial(jax.jit, static_argnames=("subtract_black", "algorithm"))
def raw_to_grey_linear(
    mosaic: jnp.ndarray,
    color_map: jnp.ndarray,
    black_levels: jnp.ndarray,
    wb: jnp.ndarray,
    white_level: float = 65535.0,
    subtract_black: bool = True,
    algorithm: str = "mhc",
) -> jnp.ndarray:
    """CCIR-601 luma of the linear RGB (reference core/RawConv.py:549-556).

    The reference rounds RGB to uint16 before the luma sum; we keep
    float32 throughout (sub-ADU difference, within test tolerance).
    """
    rgb = raw_to_rgb(mosaic, color_map, black_levels, wb, white_level,
                     subtract_black, algorithm=algorithm)
    coeff = jnp.array(CCIR601, dtype=jnp.float32)
    # full f32 product: at 65535 ADU a TF32 dot is off by tens of ADU
    return jnp.matmul(jnp.clip(rgb, 0.0, MAX_ADU), coeff,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("subtract_black",))
def raw_to_grey_direct(
    mosaic: jnp.ndarray,
    color_map: jnp.ndarray,
    black_levels: jnp.ndarray,
    wb: jnp.ndarray,
    subtract_black: bool = True,
) -> jnp.ndarray:
    """Documented 'direct' grey: each site scaled by its band's WB factor,
    no interpolation (reference core/RawConv.py:500-501,533-547 — the
    reference implementation is broken, SURVEY.md §2.8; this implements
    the documented semantics)."""
    f = mosaic.astype(jnp.float32)
    if subtract_black:
        f = safe_subtract_black(f, color_map, black_levels)
    return f * wb.astype(jnp.float32)[color_map]


@jax.jit
def split_channels(
    mosaic: jnp.ndarray,
    color_map: jnp.ndarray,
    black_levels: jnp.ndarray,
    subtract_black: bool = True,
) -> jnp.ndarray:
    """(4, H, W) full-size per-band images, zero off-band.

    Reference split() semantics (core/RawConv.py:589-618): each output
    keeps only its band's pixels at their original positions, zero
    elsewhere, optionally black-subtracted with the wraparound guard.
    """
    f = mosaic.astype(jnp.float32)
    sub = safe_subtract_black(f, color_map, black_levels)
    f = jnp.where(subtract_black, sub, f)
    return jnp.stack([jnp.where(color_map == c, f, 0.0) for c in (R, G1, B, G2)])


@jax.jit
def wb_from_region(
    mosaic_sub: jnp.ndarray,
    color_map: jnp.ndarray,
    region: jnp.ndarray,
) -> jnp.ndarray:
    """White balance multipliers from per-band means in a region.

    Reference _get_whitebalance_from_region (core/RawConv.py:291-366):
    per-band mean of (black-subtracted) site values inside the region
    [rowmin, rowmax, colmin, colmax] (inclusive, 0-based), then
    multipliers max(avg)/avg — brightest band gets 1.0.
    ``region`` is a (4,) int array; pass [0, H-1, 0, W-1] for 'auto'.
    """
    h, w = mosaic_sub.shape
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    in_region = ((rows >= region[0]) & (rows <= region[1])
                 & (cols >= region[2]) & (cols <= region[3]))
    avgs = []
    for c in (R, G1, B, G2):
        m = in_region & (color_map == c)
        n = jnp.maximum(jnp.sum(m), 1)
        avgs.append(jnp.sum(jnp.where(m, mosaic_sub, 0.0)) / n)
    avg = jnp.stack(avgs)
    return jnp.max(avg) / jnp.maximum(avg, 1e-12)


@jax.jit
def percentile_renorm(
    img: jnp.ndarray,
    lo_pct: float = 0.01,
    hi_pct: float = 99.99,
) -> jnp.ndarray:
    """Linear stretch from [p_lo, p_hi] to [0, 65535]
    (reference core/RawConv.py:462-471)."""
    flat = img.reshape(-1)
    lo = jnp.percentile(flat, lo_pct)
    hi = jnp.percentile(flat, hi_pct)
    return (img - lo) * (MAX_ADU / jnp.maximum(hi - lo, 1e-12))
