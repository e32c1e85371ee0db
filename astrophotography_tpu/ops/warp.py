"""Inverse-mapped image warping with Lanczos3 interpolation.

Device-native replacement for swarp's resampling stage (reference
scripts/resample_all.sh:330-342: LANCZOS3 resampling onto a common
grid before co-addition).  Each output pixel applies the inverse
transform (output/reference grid -> input frame coords) and evaluates a
separable 6x6 Lanczos3 kernel via gathers; out-of-frame taps produce a
fractional weight/coverage map like swarp's weight output
(resample_all.sh:342).

Transforms are (2, 3) affine matrices [A | t] mapping output (x, y)
to input coords — a Similarity.matrix() from ops/register.py slots in
directly (its ref->tgt convention IS the inverse map when warping the
target onto the reference grid).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

LANCZOS_A = 3

#: minimax-style polynomial of lanczos3(t) in u = t^2 on [0, 9]
#: (max abs error 2.8e-6); lets warp weights evaluate without
#: transcendentals or tap routing
_L3_POLY = (
    9.999994525888e-01,
    -1.827688926461e+00,
    1.122335944632e+00,
    -3.557261514981e-01,
    6.945395735140e-02,
    -9.185528553885e-03,
    8.680491817837e-04,
    -5.970731138175e-05,
    2.910034981863e-06,
    -9.078439824764e-08,
    1.359070044584e-09,
)


def _lanczos3_poly(t: jnp.ndarray) -> jnp.ndarray:
    """lanczos3 weight via the polynomial in t^2 (zero for |t| >= 3)."""
    u = t * t
    acc = jnp.float32(_L3_POLY[-1])
    for c in _L3_POLY[-2::-1]:
        acc = acc * u + jnp.float32(c)
    return jnp.where(u < 9.0, acc, 0.0)


def _lanczos_weights(frac: jnp.ndarray, a: int = LANCZOS_A) -> jnp.ndarray:
    """(..., 2a) separable Lanczos weights for tap offsets -a+1 .. a.

    ``frac`` is the fractional coordinate in [0, 1); taps are at integer
    offsets relative to floor(coord).
    """
    offsets = jnp.arange(-a + 1, a + 1, dtype=jnp.float32)  # (2a,)
    x = frac[..., None] - offsets  # distance to each tap
    eps = 1e-6
    safe = jnp.where(jnp.abs(x) < eps, 1.0, x)
    sinc = jnp.where(
        jnp.abs(x) < eps, 1.0,
        jnp.sin(jnp.pi * safe) / (jnp.pi * safe))
    sinc_a = jnp.where(
        jnp.abs(x) < eps, 1.0,
        jnp.sin(jnp.pi * safe / a) / (jnp.pi * safe / a))
    w = jnp.where(jnp.abs(x) < a, sinc * sinc_a, 0.0)
    return w


@functools.partial(jax.jit, static_argnames=("out_shape",))
def warp_affine_lanczos3(
    img: jnp.ndarray,
    matrix: jnp.ndarray,
    out_shape: Tuple[int, int],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp ``img`` onto an (H_out, W_out) grid.

    ``matrix`` (2, 3) maps output (x, y, 1) to input (x, y).  Returns
    (warped, weight) where weight is the in-bounds kernel coverage in
    [0, 1] (0 outside the source frame) — the swarp-style weight map.
    """
    img = img.astype(jnp.float32)
    h_in, w_in = img.shape
    h_out, w_out = out_shape
    a = LANCZOS_A

    ys = jnp.arange(h_out, dtype=jnp.float32)
    xs = jnp.arange(w_out, dtype=jnp.float32)
    xg, yg = jnp.meshgrid(xs, ys)
    sx = matrix[0, 0] * xg + matrix[0, 1] * yg + matrix[0, 2]
    sy = matrix[1, 0] * xg + matrix[1, 1] * yg + matrix[1, 2]

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    wx = _lanczos_weights(fx)    # (H, W, 6)
    wy = _lanczos_weights(fy)    # (H, W, 6)

    acc = jnp.zeros(out_shape, jnp.float32)
    wacc = jnp.zeros(out_shape, jnp.float32)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    for dy in range(2 * a):
        ty = y0i + (dy - a + 1)
        in_y = (ty >= 0) & (ty < h_in)
        tyc = jnp.clip(ty, 0, h_in - 1)
        for dx in range(2 * a):
            tx = x0i + (dx - a + 1)
            in_x = (tx >= 0) & (tx < w_in)
            txc = jnp.clip(tx, 0, w_in - 1)
            wgt = wy[..., dy] * wx[..., dx]
            inb = (in_y & in_x).astype(jnp.float32)
            acc = acc + wgt * inb * img[tyc, txc]
            wacc = wacc + wgt * inb
    # value = acc / wacc renormalizes the kernel where taps fell outside
    # the frame (flux-preserving at edges); zero where nothing sampled
    total_w = jnp.sum(wy, axis=-1) * jnp.sum(wx, axis=-1)
    coverage = wacc / jnp.maximum(total_w, 1e-9)
    out = jnp.where(wacc != 0.0, acc / jnp.where(wacc != 0.0, wacc, 1.0), 0.0)
    return out, jnp.clip(coverage, 0.0, 1.0)


@functools.partial(jax.jit,
                   static_argnames=("out_shape", "band", "span",
                                    "analytic_coverage",
                                    "translation_budget"))
def warp_affine_separable(
    img: jnp.ndarray,
    matrix: jnp.ndarray,
    out_shape: Tuple[int, int],
    band: int = 64,
    span: int = 24,
    analytic_coverage: bool = False,
    translation_budget: "int | None" = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather-free two-pass Lanczos3 affine warp (the stacking path).

    Instead of per-pixel gathers this implements the classic
    two-pass separable decomposition (Heckbert): a horizontal resample
    along source rows followed by a vertical resample.  Each pass
    processes ``band`` rows at a time: one ``dynamic_slice`` positions
    a (band x (width+span)) window at the band's integer base offset,
    then ``span`` statically-shifted multiply-adds accumulate the 6
    Lanczos taps, routed to the correct shift by integer-equality
    masks.  Everything is elementwise work streamed at memory bandwidth.

    Correctness domain: |m11| bounded away from 0 and the in-band
    source-offset variation must fit in span-6:
    |gx-1|*W + |gy|*band <= span-6 (pass 1) and
    |m10|*W + |m11-1|*band <= span-6 (pass 2).  With the defaults this
    covers rotations up to ~0.5 deg at 2k width (raise ``span`` for
    more).  Out-of-domain pixels degrade to zero coverage, not wrong
    values, because unmatched taps simply find no equal shift.

    The two-pass result samples along sheared rows; it equals the
    direct 2-D kernel exactly for pure translations and differs at the
    1e-3 level on smooth images for stacking-scale rotations.
    Returns (warped, coverage) like warp_affine_lanczos3.

    ``translation_budget`` (px, static): the declared max |translation|.
    None (default) sizes the transient pads for ANY in-coverage shift —
    safe but ~3x the image per axis; a finite budget shrinks the pads
    to budget-scale, and frames shifted beyond (budget - span - 4) are
    excluded via coverage rather than resampled wrongly.
    """
    img = img.astype(jnp.float32)
    h_in, w_in = img.shape
    h_out, w_out = out_shape
    band = min(band, h_in, h_out)
    m00, m01, m02 = matrix[0, 0], matrix[0, 1], matrix[0, 2]
    m10, m11, m12 = matrix[1, 0], matrix[1, 1], matrix[1, 2]

    # exact decomposition out[y, x] = mid[sy(x,y), x],
    # mid[y', x] = in[y', g(x, y')] with g(x, sy(x,y)) == sx(x,y)
    inv_m11 = 1.0 / m11
    gx = m00 - m01 * m10 * inv_m11
    gy = m01 * inv_m11
    g0 = m02 - m01 * m12 * inv_m11

    # left/top padding must absorb the largest negative source offset a
    # covered output pixel can produce: |translation| up to a full
    # output dimension plus the tap footprint (a tighter span+6 pad
    # silently zeroed frames translated left/up by more than ~span px —
    # their taps fell outside the clipped block while analytic coverage
    # still reported them valid).  ``translation_budget`` trades that
    # full-safety pad (a ~3x-per-axis transient copy) for a declared
    # |shift| bound: pads shrink to budget-scale and, in analytic mode,
    # coverage additionally requires |source - output| <= budget -
    # span - 4 per axis, so an out-of-budget frame degrades to zero
    # COVERAGE (excluded from the combine), never to zero values
    # counted as data.
    if translation_budget is not None:
        if translation_budget < span + 5:
            raise ValueError("translation_budget must exceed span + 4")
        pad = translation_budget + span + 4
    else:
        pad = w_out + span + 4
    if analytic_coverage:
        # coverage of an affine warp is analytic: a pixel is covered iff
        # its source coordinate keeps the full 6-tap footprint inside the
        # frame; skipping the warped ones-channel halves the work
        src = img[None]
    else:
        # channel 0: data, channel 1: ones (coverage tracking); the ones
        # channel is 1 only over the true image so zero-padding handles
        # out-of-frame taps for both passes at once
        src = jnp.stack([img, jnp.ones_like(img)])
    nchan = src.shape[0]

    n_bands1 = -(-h_in // band)
    rows_pad1 = n_bands1 * band - h_in
    # right/bottom pads are sized so the base clip below never excludes
    # a tap that could touch the real image (base can reach dim + 3)
    pad_r = pad
    src_p = jnp.pad(src, ((0, 0), (0, rows_pad1), (pad, pad_r)))
    xs_out = jnp.arange(w_out, dtype=jnp.float32)
    xi_out = jnp.arange(w_out, dtype=jnp.int32)

    def resample_terms(coord_loc, block, length, axis, idx_along):
        """Accumulate span statically-shifted slices weighted by the
        Lanczos taps of per-pixel coordinate ``coord_loc`` (block-local).

        The weight of shift s at a pixel is simply lanczos3(distance to
        that absolute block index), evaluated by polynomial — no
        floor/tap-routing selects, no transcendentals.  Weights are
        renormalized by their running sum (partition of unity), which
        also absorbs the poly's 3e-6 truncation error.
        """
        idx_f = idx_along.astype(jnp.float32)
        acc = None
        wsum = None
        for s in range(span):
            t = coord_loc - (idx_f + s)
            w = _lanczos3_poly(t)
            term = w[None] * jax.lax.dynamic_slice_in_dim(
                block, s, length, axis=axis)
            acc = term if acc is None else acc + term
            wsum = w if wsum is None else wsum + w
        safe = jnp.abs(wsum) > 1e-3
        return jnp.where(safe[None], acc / jnp.where(safe, wsum, 1.0)[None],
                         0.0)

    def hband(b):
        r0 = b * band
        rows = r0.astype(jnp.float32) + jnp.arange(band, dtype=jnp.float32)
        u = gx * xs_out[None, :] + gy * rows[:, None] + g0   # (band, w_out)
        base = jnp.floor(jnp.min(u)).astype(jnp.int32) - 3
        base = jnp.clip(base, -pad, w_in + 3)
        block = jax.lax.dynamic_slice(
            src_p, (0, r0, base + pad), (nchan, band, w_out + span))
        return resample_terms(u - base.astype(jnp.float32), block,
                              w_out, axis=2, idx_along=xi_out[None, :])

    mid = jax.lax.map(hband, jnp.arange(n_bands1))
    mid = jnp.moveaxis(mid, 1, 0).reshape(nchan, n_bands1 * band, w_out)
    mid = mid[:, :h_in, :]

    # vertical pass: out[y, x] = mid[v(x, y), x]
    pad_t = pad if translation_budget is not None else h_out + span + 4
    pad_b = band + span + 4
    mid_p = jnp.pad(mid, ((0, 0), (pad_t, pad_b), (0, 0)))
    n_bands2 = -(-h_out // band)
    ri_band = jnp.arange(band, dtype=jnp.int32)

    def vband(b):
        r0 = b * band
        rows = r0.astype(jnp.float32) + jnp.arange(band, dtype=jnp.float32)
        v = m10 * xs_out[None, :] + m11 * rows[:, None] + m12
        base = jnp.floor(jnp.min(v)).astype(jnp.int32) - 3
        base = jnp.clip(base, -pad_t, h_in + 3)
        block = jax.lax.dynamic_slice(
            mid_p, (0, base + pad_t, 0), (nchan, band + span, w_out))
        return resample_terms(v - base.astype(jnp.float32), block,
                              band, axis=1, idx_along=ri_band[:, None])

    out2 = jax.lax.map(vband, jnp.arange(n_bands2))
    out2 = jnp.moveaxis(out2, 1, 0).reshape(nchan, n_bands2 * band, w_out)
    out2 = out2[:, :h_out, :]
    if analytic_coverage:
        # covered iff the full 6-tap footprint stays inside the source:
        # evaluate the affine source coords on the output grid directly
        ys_o = jnp.arange(h_out, dtype=jnp.float32)[:, None]
        xs_o = jnp.arange(w_out, dtype=jnp.float32)[None, :]
        sx = m00 * xs_o + m01 * ys_o + m02
        sy = m10 * xs_o + m11 * ys_o + m12
        cov_b = (sx >= 2.0) & (sx <= w_in - 4.0) \
            & (sy >= 2.0) & (sy <= h_in - 4.0)
        if translation_budget is not None:
            # a covered pixel's |shift| bounded away from the budget by
            # span + 4 guarantees its band's block base never hits the
            # pad clip (in-band spread is <= span - 6 by the domain
            # condition), so values under the shrunken pads stay exact
            b_eff = float(translation_budget - span - 4)
            cov_b = cov_b & (jnp.abs(sx - xs_o) <= b_eff) \
                & (jnp.abs(sy - ys_o) <= b_eff)
        cover = cov_b.astype(jnp.float32)
        return out2[0] * cover, cover
    data, cover = out2[0], out2[1]
    out = jnp.where(cover > 1e-6,
                    data / jnp.where(cover > 1e-6, cover, 1.0), 0.0)
    return out, jnp.clip(cover, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("out_shape",))
def warp_affine_bilinear(
    img: jnp.ndarray,
    matrix: jnp.ndarray,
    out_shape: Tuple[int, int],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cheaper bilinear warp (swarp COMBINE quick-look analogue)."""
    img = img.astype(jnp.float32)
    h_in, w_in = img.shape
    h_out, w_out = out_shape
    ys = jnp.arange(h_out, dtype=jnp.float32)
    xs = jnp.arange(w_out, dtype=jnp.float32)
    xg, yg = jnp.meshgrid(xs, ys)
    sx = matrix[0, 0] * xg + matrix[0, 1] * yg + matrix[0, 2]
    sy = matrix[1, 0] * xg + matrix[1, 1] * yg + matrix[1, 2]
    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    acc = jnp.zeros(out_shape, jnp.float32)
    wacc = jnp.zeros(out_shape, jnp.float32)
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        ty = y0i + dy
        tx = x0i + dx
        inb = ((ty >= 0) & (ty < h_in) & (tx >= 0) & (tx < w_in)) \
            .astype(jnp.float32)
        tyc = jnp.clip(ty, 0, h_in - 1)
        txc = jnp.clip(tx, 0, w_in - 1)
        acc = acc + wgt * inb * img[tyc, txc]
        wacc = wacc + wgt * inb
    out = jnp.where(wacc > 0, acc / jnp.maximum(wacc, 1e-9), 0.0)
    return out, jnp.clip(wacc, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("in_shape", "out_shape"))
def coverage_weight_map(
    matrices: jnp.ndarray,
    in_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
    frame_weights: jnp.ndarray,
) -> jnp.ndarray:
    """swarp-style coadd weight map on the output grid.

    Per output pixel: sum over frames of ``frame_weights[i]`` times the
    analytic tap-footprint coverage of frame i (1 iff the full Lanczos3
    footprint of the mapped source coordinate stays inside the
    ``in_shape`` frame — the same criterion warp_affine_separable's
    analytic coverage applies).  This is the WEIGHTOUT image the
    reference's swarp invocation produces (resample_all.sh:342); with
    FSCALE exposure scaling the per-frame weight is 1/fscale^2 (swarp
    propagates input weights as inverse variance).  Frames rejected by
    registration carry the REJECTED_TRANSLATION sentinel in their
    matrix and fall out of coverage naturally.

    Exactness caveat: this map mirrors the analytic-coverage separable
    combine path.  The interp='lanczos3'/'bilinear' paths mask output
    pixels whose
    fractional tap coverage is <= 0.5 near frame edges; in those
    regimes the map can claim weight up to one tap footprint (~5 px)
    past what that engine actually accumulated.  Callers stacking with
    extreme dithers should treat edge weights as an upper bound.
    """
    h_in, w_in = (float(v) for v in in_shape)
    hh, ww = out_shape
    ys = jnp.arange(hh, dtype=jnp.float32)[:, None]
    xs = jnp.arange(ww, dtype=jnp.float32)[None, :]

    def one(m, wgt):
        sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
        sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
        cov = ((sx >= 2.0) & (sx <= w_in - 4.0)
               & (sy >= 2.0) & (sy <= h_in - 4.0))
        return cov.astype(jnp.float32) * wgt

    return jnp.sum(
        jax.vmap(one)(matrices.astype(jnp.float32),
                      frame_weights.astype(jnp.float32)), axis=0)
