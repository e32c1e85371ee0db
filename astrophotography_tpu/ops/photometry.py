"""Vectorized circular-aperture photometry.

Device-native replacement for the reference's per-star Python loop over
photutils annulus masks (core/ApFindStars.py:363-446, the hot loop at
:383-389).  All stars are processed at once: per-star cutouts are
gathered with dynamic slices, aperture coverage uses an anti-aliased
circular edge (±0.5 px linear ramp — a close approximation of
photutils' exact circle/pixel overlap), and the annulus background is a
sigma-clipped median over the cutout ring, vmapped across stars.

Geometry matches the reference _make_apertures
(core/ApFindStars.py:272-297): aperture radius = ceil(2 * fwhm),
annulus from that radius to ceil(1.5 * radius), background counted as
median * pi * r^2 (photutils' analytic aperture area).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .stats import sigma_clip_mask, masked_median


class Photometry(NamedTuple):
    """Per-star photometry (fixed capacity, aligned with the Stars table)."""

    aperture_sum: jnp.ndarray    # background-corrected ADU in aperture
    bgmed_per_pix: jnp.ndarray   # sigma-clipped annulus median per pixel
    adu_per_sec: jnp.ndarray
    magnitude: jnp.ndarray       # instrumental: -2.5 log10(adu_per_sec)
    valid: jnp.ndarray


def aperture_radii(fwhm: float, ap_fwhm_mult: float = 2.0):
    """(r_aperture, r_outer) per the reference geometry."""
    r_ap = math.ceil(ap_fwhm_mult * fwhm)
    return r_ap, math.ceil(1.5 * r_ap)


def _disk_quadrant_area(x, y, r):
    """Area of {X <= x, Y <= y, X^2 + Y^2 <= r^2} for a disk of radius
    ``r`` centered at the origin (closed form; elementwise).

    Building block of the EXACT circle/pixel overlap: the disk-pixel
    intersection area is the 2-D inclusion-exclusion of this quadrant
    integral over the pixel corners (photutils' exact mode computes the
    same geometry by polygon clipping)."""
    r = jnp.float32(r)
    xh = jnp.clip(x, -r, r)
    yh = jnp.clip(y, -r, r)

    def seg(a, b):
        # integral of sqrt(r^2 - X^2) dX over [a, b] (a, b in [-r, r])
        def anti(u):
            s = jnp.sqrt(jnp.maximum(r * r - u * u, 0.0))
            return 0.5 * (u * s + r * r * jnp.arcsin(
                jnp.clip(u / r, -1.0, 1.0)))
        b = jnp.maximum(b, a)
        return anti(b) - anti(a)

    t = jnp.sqrt(jnp.maximum(r * r - yh * yh, 0.0))
    # integral of clamp(yh, -s(X), s(X)) over [-r, xh]: the |X| > t
    # flanks contribute sign(yh) * s(X), the middle contributes yh
    sgn = jnp.sign(yh)
    c = (sgn * seg(-r, jnp.minimum(xh, -t))
         + yh * jnp.maximum(jnp.minimum(xh, t) + t, 0.0)
         + sgn * seg(t, jnp.maximum(xh, t)))
    return c + seg(-r, xh)


def _exact_cover(dx, dy, r):
    """Exact disk/pixel overlap area for pixels centered at (dx, dy)."""
    f = _disk_quadrant_area
    return (f(dx + 0.5, dy + 0.5, r) - f(dx - 0.5, dy + 0.5, r)
            - f(dx + 0.5, dy - 0.5, r) + f(dx - 0.5, dy - 0.5, r))


@functools.partial(jax.jit, static_argnames=("r_ap", "r_out",
                                             "edge_method"))
def aperture_photometry(
    data: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    valid: jnp.ndarray,
    r_ap: int,
    r_out: int,
    exposure: float = 1.0,
    edge_method: str = "exact",
) -> Photometry:
    """Photometer all stars at (x, y) in one vectorized pass.

    ``data`` is the NON-background-subtracted image (the reference
    photometers self._data and subtracts the annulus median,
    core/ApFindStars.py:385-400).

    ``edge_method``: 'exact' (default) uses the closed-form circle/
    pixel overlap area — photutils' exact mode, matching the reference
    photometry to machine precision; 'ramp' is the cheaper +-0.5 px
    linear-edge approximation (<= 0.5 % flux error, see
    tests/test_accuracy_bounds.py).
    """
    data = data.astype(jnp.float32)
    h, w = data.shape
    half = r_out + 1
    box = 2 * half + 1

    ys = jnp.arange(box, dtype=jnp.float32)
    xs = jnp.arange(box, dtype=jnp.float32)

    def per_star(cx, cy):
        iy = jnp.clip(jnp.round(cy).astype(jnp.int32) - half, 0, h - box)
        ix = jnp.clip(jnp.round(cx).astype(jnp.int32) - half, 0, w - box)
        cut = jax.lax.dynamic_slice(data, (iy, ix), (box, box))
        dy = ys[:, None] + iy.astype(jnp.float32) - cy
        dx = xs[None, :] + ix.astype(jnp.float32) - cx
        dist = jnp.sqrt(dy * dy + dx * dx)
        if edge_method == "exact":
            cover = _exact_cover(dx, dy, r_ap)
        else:
            # anti-aliased coverage: 1 inside, 0 outside, linear edge
            cover = jnp.clip(r_ap + 0.5 - dist, 0.0, 1.0)
        ap_sum = jnp.sum(cut * cover)
        # annulus ring, pixel-center test (photutils method='center',
        # core/ApFindStars.py:295-296)
        ring = (dist >= r_ap) & (dist < r_out)
        keep = sigma_clip_mask(cut.reshape(-1), ring.reshape(-1),
                               sigma_lower=3.0, sigma_upper=3.0, maxiters=5)
        bgmed = masked_median(cut.reshape(-1), keep)
        return ap_sum, bgmed

    ap_sums, bgmeds = jax.vmap(per_star)(x.astype(jnp.float32),
                                         y.astype(jnp.float32))
    area = jnp.float32(math.pi * r_ap * r_ap)
    corrected = ap_sums - bgmeds * area
    adu_per_sec = corrected / jnp.float32(exposure)
    magnitude = -2.5 * jnp.log10(jnp.maximum(adu_per_sec, 1e-12))
    zero = jnp.zeros_like(ap_sums)
    return Photometry(
        aperture_sum=jnp.where(valid, corrected, zero),
        bgmed_per_pix=jnp.where(valid, bgmeds, zero),
        adu_per_sec=jnp.where(valid, adu_per_sec, zero),
        magnitude=jnp.where(valid, magnitude, zero),
        valid=valid,
    )
