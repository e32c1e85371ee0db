"""L.A.Cosmic cosmic-ray detection/removal as a fixed-iteration XLA loop.

Device-native replacement for astroscrappy (Cython) as invoked through
ccdproc by the reference (core/ApFixCosmicRays.py:265-295: gain-applied
electrons, sigclip=4.5, readnoise=12 e-, fsmode='convolve' with a
Gaussian PSF of fwhm=3.5 / size=7, satlevel = gain*65535, niter=6).
Implements van Dokkum (2001) with astroscrappy's structure:

per iteration —
1. 2x block-replicated subsampling, 3x3 Laplacian, negative clip,
   2x2 block average back (L+); S = L+/(2 noise) with noise =
   sqrt(median5(img) + rn^2); S' = S - median5(S);
2. fine-structure image: base = convolve(img, psf) (fsmode='convolve',
   the reference's invocation) or median3(img) (fsmode='median', the
   paper's original); F = (base - median7(base)) / noise, floored at
   0.01; candidates need S' > sigclip AND S'/F > objlim — the F test
   rejects genuine point sources whose fine structure is PSF-like;
3. two-stage neighbor growth (astroscrappy): dilate once gated at the
   full sigclip, then dilate gated at sigclip*sigfrac;
4. saturated stars excluded; masked pixels replaced by the 5x5 median
   of unmasked neighbors.

The iteration count is static (jit-friendly); the cumulative CR mask
and the cleaned image are returned.

All median filters are shift-stack sorts on the device and the PSF
convolution is a static shifted-add stencil; there is no gather and no
data-dependent control flow anywhere.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .stencil import conv2d_static

from .stats import masked_median


def _median_filter(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """size x size median filter with edge clamping."""
    h, w = img.shape
    half = size // 2
    padded = jnp.pad(img, half, mode="edge")
    stack = jnp.stack([padded[dy:dy + h, dx:dx + w]
                       for dy in range(size) for dx in range(size)])
    return jnp.median(stack, axis=0)


def _masked_median_filter(img: jnp.ndarray, good: jnp.ndarray,
                          size: int) -> jnp.ndarray:
    h, w = img.shape
    half = size // 2
    padded = jnp.pad(img, half, mode="edge")
    pgood = jnp.pad(good, half, mode="constant", constant_values=False)
    vals = jnp.stack([padded[dy:dy + h, dx:dx + w]
                      for dy in range(size) for dx in range(size)])
    ok = jnp.stack([pgood[dy:dy + h, dx:dx + w]
                    for dy in range(size) for dx in range(size)])
    return masked_median(vals, ok, axis=0)


def _laplacian_subsampled(img: jnp.ndarray) -> jnp.ndarray:
    """L+ of van Dokkum: Laplacian on the 2x-supersampled image,
    clipped at zero, block-averaged back."""
    h, w = img.shape
    up = jnp.repeat(jnp.repeat(img, 2, axis=0), 2, axis=1)
    padded = jnp.pad(up, 1, mode="edge")
    lap = (4.0 * up
           - padded[0:-2, 1:-1] - padded[2:, 1:-1]
           - padded[1:-1, 0:-2] - padded[1:-1, 2:])
    lap = jnp.maximum(lap, 0.0)
    return lap.reshape(h, 2, w, 2).mean(axis=(1, 3)) * 2.0


def _gaussian_psf_kernel(fwhm: float, size: int) -> np.ndarray:
    """Normalized 2-D Gaussian PSF template (astroscrappy gausskernel)."""
    sigma = fwhm / 2.35482
    half = size // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _conv_static(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Static-stencil convolution, edge-padded (see ops/stencil.py)."""
    return conv2d_static(img, kernel, pad_mode="edge")


def _dilate3(mask: jnp.ndarray) -> jnp.ndarray:
    h, w = mask.shape
    p = jnp.pad(mask, 1)
    out = jnp.zeros_like(mask)
    for dy in range(3):
        for dx in range(3):
            out = out | p[dy:dy + h, dx:dx + w]
    return out


@functools.partial(jax.jit,
                   static_argnames=("niter", "fsmode", "psffwhm", "psfsize"))
def lacosmic(
    img_adu: jnp.ndarray,
    gain: float = 1.0,
    readnoise: float = 12.0,
    sigclip: float = 4.5,
    sigfrac: float = 0.3,
    objlim: float = 5.0,
    satlevel_e: float = 65535.0,
    niter: int = 6,
    fsmode: str = "convolve",
    psffwhm: float = 3.5,
    psfsize: int = 7,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Clean cosmic rays; returns (cleaned ADU image, CR mask bool).

    Parameter defaults follow the reference's hardwired astroscrappy
    call (core/ApFixCosmicRays.py:265-284), including
    ``fsmode='convolve'`` with a Gaussian PSF template (fwhm 3.5,
    size 7).  ``satlevel_e`` is in electrons (pass gain*65535 to match
    the reference).  ``fsmode='median'`` selects the paper's original
    median fine-structure image.
    """
    if fsmode not in ("convolve", "median"):
        raise ValueError(f"fsmode must be 'convolve' or 'median', "
                         f"got {fsmode!r}")
    img_e = img_adu.astype(jnp.float32) * jnp.float32(gain)
    rn2 = jnp.float32(readnoise) ** 2
    psfk = _gaussian_psf_kernel(psffwhm, psfsize) \
        if fsmode == "convolve" else None

    # saturated stars (and their halos) are never cosmic rays — but only
    # EXTENDED saturated structure qualifies (astroscrappy: the 5x5
    # median must also be high), else a very bright single-pixel CR
    # above satlevel would protect itself
    sat = ((img_e > jnp.float32(satlevel_e))
           & (_median_filter(img_e, 5) > jnp.float32(satlevel_e) / 10.0))
    satgrow = sat
    for _ in range(2):
        satgrow = _dilate3(satgrow)

    def body(state, _):
        clean, crmask = state
        lplus = _laplacian_subsampled(clean)
        med5 = jnp.maximum(_median_filter(clean, 5), 1e-5)
        noise = jnp.sqrt(med5 + rn2)
        s = lplus / (2.0 * noise)
        sprime = s - _median_filter(s, 5)
        # fine-structure image (astroscrappy: base - median7(base),
        # noise-normalized, floored)
        if fsmode == "convolve":
            base = _conv_static(clean, psfk)
        else:
            base = _median_filter(clean, 3)
        fine = (base - _median_filter(base, 7)) / noise
        fine = jnp.maximum(fine, 0.01)
        candidate = ((sprime > sigclip) & (sprime / fine > objlim)
                     & ~satgrow)
        # two-stage neighbor growth (astroscrappy detect_cosmics):
        # dilation gated at full sigclip, then at sigclip*sigfrac
        grown = candidate | (_dilate3(candidate)
                             & (sprime > sigclip) & ~satgrow)
        grown = grown | (_dilate3(grown)
                         & (sprime > sigclip * sigfrac) & ~satgrow)
        new_mask = crmask | grown
        repl = _masked_median_filter(clean, ~new_mask, 5)
        repl = jnp.where(jnp.isnan(repl), clean, repl)
        new_clean = jnp.where(grown, repl, clean)
        return (new_clean, new_mask), jnp.sum(grown)

    (clean_e, crmask), _counts = jax.lax.scan(
        body, (img_e, jnp.zeros_like(img_e, dtype=bool)), None, length=niter)
    return clean_e / jnp.float32(gain), crmask
