"""Bad-pixel detection and repair, fully vectorized.

Replaces three reference hot loops:

* ApFixBadPixels.fix_bad_pixels — a Python ``for`` over every bad pixel
  taking a cutout + np.median each (reference
  core/ApFixBadPixels.py:371-418, self-timed in ms/pixel).  Here the
  (2Δ+1)² neighborhood is materialized as a stacked shift pyramid and
  the masked median runs for all pixels at once on the device.
* ApFindBadPixels._generate_sigmaclip_mask (reference
  core/ApFindBadPixels.py:171-217).
* ApAutoBadcols._sliding_stats_1d — a Python ``for`` over every
  column/row with sigma_clipped_stats per window (reference
  core/ApAutoBadcols.py:143-167); here the sliding windows are one
  gathered (W, window) tensor clipped in parallel.

Repair semantics follow the reference exactly: the median is computed
from the ORIGINAL data (not partially-repaired data), only good pixels
inside the box count, and a pixel is repaired only if at least
``min_valid`` good neighbors exist (reference
core/ApFixBadPixels.py:388-409, _min_valid :41-45).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .stats import masked_mean_std, masked_median, sigma_clip_mask, sigma_clipped_stats

#: Bad-pixel mask bit values (reference core/ApFindBadPixels.py:26-28).
MASK_GOOD = 0
MASK_AUTO_BAD = 1
MASK_USER_BAD = 2


def _neighbor_stack(img: jnp.ndarray, deltapix: int) -> jnp.ndarray:
    """(K, H, W) stack of every pixel's (2Δ+1)² box neighborhood.

    Out-of-image positions appear in the stack but are marked invalid
    by the parallel mask stack built the same way.
    """
    p = deltapix
    h, w = img.shape
    padded = jnp.pad(img, p)
    slices = [padded[dy:dy + h, dx:dx + w]
              for dy in range(2 * p + 1) for dx in range(2 * p + 1)]
    return jnp.stack(slices, axis=0)


@functools.partial(jax.jit, static_argnames=("deltapix", "min_valid"))
def fix_bad_pixels(
    img: jnp.ndarray,
    badmask: jnp.ndarray,
    deltapix: int = 1,
    min_valid: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Replace bad pixels by the median of good pixels within ±deltapix.

    Returns ``(fixed_image, still_bad_mask)`` where ``still_bad_mask``
    is True for bad pixels that had fewer than ``min_valid`` good
    neighbors and were left untouched (the reference's updated mask,
    core/ApFixBadPixels.py:347,398-409).
    """
    img = img.astype(jnp.float32)
    bad = badmask.astype(bool)
    good = ~bad
    vals = _neighbor_stack(img, deltapix)
    # valid = inside image AND good; pad region must be invalid
    valid = _neighbor_stack(good.astype(jnp.float32), deltapix) > 0.5
    n_good = jnp.sum(valid, axis=0)
    med = masked_median(vals, valid, axis=0)
    can_fix = bad & (n_good >= min_valid)
    fixed = jnp.where(can_fix, med.astype(jnp.float32), img)
    still_bad = bad & ~can_fix
    return fixed, still_bad


@functools.partial(jax.jit, static_argnames=("sigma",))
def sigmaclip_badpix_mask(data: jnp.ndarray, sigma: float = 4.0) -> jnp.ndarray:
    """Bad-pixel mask from sigma-clipped stats of a master dark/bias.

    Reference core/ApFindBadPixels.py:171-217: compute sigma-clipped
    (mean, median, std) of the whole image, then flag pixels strictly
    outside median ± sigma*std.  Returns uint8 (1 = AUTO_BAD).
    """
    _mean, med, std = sigma_clipped_stats(data, sigma=sigma)
    lo = med - sigma * std
    hi = med + sigma * std
    return ((data < lo) | (data > hi)).astype(jnp.uint8)


def _sliding_windows_1d(vec: jnp.ndarray, window: int) -> jnp.ndarray:
    """(N, window) matrix of centered sliding windows with edge clamping.

    The reference clamps the window to the array bounds near edges
    (shorter effective windows); we replicate by marking out-of-range
    slots invalid via the companion mask from the same gather indices.
    """
    n = vec.shape[0]
    half = window // 2
    centers = jnp.arange(n)
    offsets = jnp.arange(window) - half
    idx = centers[:, None] + offsets[None, :]
    in_range = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)
    return vec[idx_c], in_range


@functools.partial(jax.jit, static_argnames=("window", "sigma", "axis"))
def auto_badcols(
    img: jnp.ndarray,
    window: int = 11,
    sigma: float = 5.0,
    axis: int = 0,
) -> jnp.ndarray:
    """Detect bad columns (axis=0) or rows (axis=1) of a master frame.

    Reference core/ApAutoBadcols.py:143-258: per-column medians, then a
    centered sliding window along the median vector whose local
    mean/std come from astropy-default 3-sigma clipping
    (sigma_clipped_stats with no sigma argument, :165); a column is bad
    when it deviates from its local window mean by >= ``sigma`` (the
    separate nsigma flag threshold, default 5) times the local window
    std.  Returns a boolean vector over columns (axis=0) or rows
    (axis=1).
    """
    med = masked_median(img, jnp.ones_like(img, bool), axis=axis)
    wins, valid = _sliding_windows_1d(med, window)
    keep = sigma_clip_mask(wins, valid, sigma_lower=3.0, sigma_upper=3.0,
                           maxiters=5, axis=1)
    mean, std = masked_mean_std(wins, keep, axis=1)
    return jnp.abs(med - mean) >= sigma * std


def combine_user_badpix(
    shape: Tuple[int, int],
    bad_columns=(),
    bad_rows=(),
    bad_rectangles=(),
) -> jnp.ndarray:
    """Rasterize user-specified bad regions to a USER_BAD uint8 mask.

    Coordinates follow the reference YAML convention: 1-based,
    inclusive ranges (reference etc/user_badpixels.yml:14-33 and
    core/ApFindBadPixels.py:70-158).  Rectangles are
    (xmin, xmax, ymin, ymax).
    """
    import numpy as np

    mask = np.zeros(shape, dtype=np.uint8)
    for col in bad_columns:
        mask[:, int(col) - 1] = MASK_USER_BAD
    for row in bad_rows:
        mask[int(row) - 1, :] = MASK_USER_BAD
    for rect in bad_rectangles:
        xmin, xmax, ymin, ymax = (int(v) for v in rect)
        mask[ymin - 1:ymax, xmin - 1:xmax] = MASK_USER_BAD
    return jnp.asarray(mask)
