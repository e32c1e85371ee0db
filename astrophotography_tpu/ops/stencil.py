"""Shared static-stencil convolution for device kernels.

Small fixed kernels (3x3 - 9x9) are written as statically shifted
multiply-adds over a padded image — elementwise work XLA fuses into a
handful of device-memory passes, with no gathers and no
conv_general_dilated lowering for single-channel images.  Every op that needs a small 2-D stencil
(detection matched filter, L.A.Cosmic PSF convolve, MHC demosaic)
shares this helper; they differ only in boundary handling.
"""

from __future__ import annotations

import jax.numpy as jnp


def conv2d_static(img: jnp.ndarray, kernel, pad_mode: str = "zero",
                  skip_zero_taps: bool = True) -> jnp.ndarray:
    """2-D correlation of ``img`` with a STATIC (host-side) kernel.

    ``kernel`` is any nested sequence / ndarray of static floats with
    odd dimensions; ``pad_mode`` is 'zero', 'edge', or 'reflect'.
    Zero-valued taps are elided at trace time when ``skip_zero_taps``
    (the MHC filters have 9-13 non-zero taps of 25).
    """
    kh = len(kernel)
    kw = len(kernel[0])
    h, w = img.shape
    pads = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    if pad_mode == "zero":
        padded = jnp.pad(img, pads)
    else:
        padded = jnp.pad(img, pads, mode=pad_mode)
    out = jnp.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            k = float(kernel[dy][dx])
            if k == 0.0 and skip_zero_taps:
                continue
            out = out + k * padded[dy:dy + h, dx:dx + w]
    return out
