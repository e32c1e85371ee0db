"""Masked/sigma-clipped statistics as jit-friendly fixed-iteration ops.

Device-native replacements for astropy.stats.sigma_clipped_stats /
mad_std, which the reference calls throughout (e.g. reference
core/ApFindStars.py:142-154, core/ApFindBadPixels.py:194-209,
core/ApAutoBadcols.py:143-167).  Semantics match astropy defaults:
center = median, deviation = std, fixed ``maxiters`` clip iterations
(astropy iterates to convergence with maxiters=5 cap; convergence is
expressed here as the mask simply not changing on later iterations,
which yields identical results).

All reductions are masked: invalid entries are excluded by weight, and
medians are computed by sorting with +inf sentinels — static shapes,
no boolean indexing.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_MAD_TO_STD = 1.482602218505602  # 1/Phi^-1(3/4), astropy.stats.mad_std scale


def _move_axis_last(x: jnp.ndarray, axis: Optional[int]):
    if axis is None:
        return x.reshape(-1), None
    return jnp.moveaxis(x, axis, -1), axis


def masked_median(x: jnp.ndarray, mask: jnp.ndarray, axis: Optional[int] = None) -> jnp.ndarray:
    """Median of elements where ``mask`` is True along ``axis``.

    Matches ``np.median`` on the selected values (average of the two
    central order statistics for even counts).  Entries with zero valid
    elements yield NaN.
    """
    xv, _ = _move_axis_last(x, axis)
    mv, _ = _move_axis_last(mask, axis)
    big = jnp.asarray(jnp.inf, dtype=xv.dtype)
    sentinel = jnp.where(mv, xv, big)
    srt = jnp.sort(sentinel, axis=-1)
    n = jnp.sum(mv, axis=-1)
    lo = jnp.maximum((n - 1) // 2, 0)
    hi = jnp.maximum(n // 2, 0)
    k = srt.shape[-1]
    if k <= 64:
        # per-element take_along_axis lowers to a gather; for short
        # reduction axes an iota-match select-sum is a plain
        # elementwise reduction that fuses with the sort's consumer
        iota = jnp.arange(k)
        lo_val = jnp.sum(jnp.where(iota == lo[..., None], srt, 0), axis=-1)
        hi_val = jnp.sum(jnp.where(iota == hi[..., None], srt, 0), axis=-1)
    else:
        lo_val = jnp.take_along_axis(srt, lo[..., None], axis=-1)[..., 0]
        hi_val = jnp.take_along_axis(srt, hi[..., None], axis=-1)[..., 0]
    med = 0.5 * (lo_val + hi_val)
    return jnp.where(n > 0, med, jnp.nan)


def masked_mean_std(
    x: jnp.ndarray, mask: jnp.ndarray, axis: Optional[int] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean and (population) std over elements where mask is True."""
    xv, _ = _move_axis_last(x, axis)
    mv, _ = _move_axis_last(mask, axis)
    mvf = mv.astype(xv.dtype)
    n = jnp.sum(mvf, axis=-1)
    n_safe = jnp.maximum(n, 1.0)
    mean = jnp.sum(xv * mvf, axis=-1) / n_safe
    var = jnp.sum(((xv - mean[..., None]) ** 2) * mvf, axis=-1) / n_safe
    std = jnp.sqrt(var)
    empty = n == 0
    return jnp.where(empty, jnp.nan, mean), jnp.where(empty, jnp.nan, std)


def mad_std(x: jnp.ndarray, mask: Optional[jnp.ndarray] = None,
            axis: Optional[int] = None) -> jnp.ndarray:
    """Robust sigma estimate: 1.4826 * median(|x - median(x)|)."""
    if mask is None:
        mask = jnp.ones_like(x, dtype=bool)
    med = masked_median(x, mask, axis=axis)
    if axis is None:
        dev = jnp.abs(x - med)
    else:
        dev = jnp.abs(x - jnp.expand_dims(med, axis))
    return _MAD_TO_STD * masked_median(dev, mask, axis=axis)


@functools.partial(jax.jit, static_argnames=("sigma_lower", "sigma_upper",
                                             "maxiters", "axis", "cenfunc",
                                             "stdfunc"))
def sigma_clip_mask(
    x: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    sigma_lower: float = 3.0,
    sigma_upper: float = 3.0,
    maxiters: int = 5,
    axis: Optional[int] = None,
    cenfunc: str = "median",
    stdfunc: str = "std",
) -> jnp.ndarray:
    """Iterative sigma clip; returns the surviving-values mask (True=keep).

    ``cenfunc``/``stdfunc`` select median|mean and std|mad_std, covering
    both astropy's defaults and ccdproc.combine's
    (func=median, dev_func=mad_std — reference
    scripts/ap_combine_darks.py:411-420).
    """
    keep = jnp.ones_like(x, dtype=bool) if mask is None else mask

    def body(_i, keep):
        if cenfunc == "median":
            center = masked_median(x, keep, axis=axis)
        else:
            center, _ = masked_mean_std(x, keep, axis=axis)
        if stdfunc == "std":
            _, std = masked_mean_std(x, keep, axis=axis)
        else:
            std = mad_std(x, keep, axis=axis)
        if axis is not None:
            center = jnp.expand_dims(center, axis)
            std = jnp.expand_dims(std, axis)
        within = (x >= center - sigma_lower * std) & (x <= center + sigma_upper * std)
        # astropy's mask grows monotonically: once clipped, stays clipped
        return keep & within

    for i in range(maxiters):
        keep = body(i, keep)
    return keep


def sigma_clipped_stats(
    x: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    sigma: float = 3.0,
    maxiters: int = 5,
    axis: Optional[int] = None,
    cenfunc: str = "median",
    stdfunc: str = "std",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(mean, median, std) of sigma-clipped data — astropy-compatible.

    ``mask`` True means *valid* (note: inverse of astropy's convention,
    consistent with every masked op in this package).
    """
    keep = sigma_clip_mask(x, mask, sigma_lower=sigma, sigma_upper=sigma,
                           maxiters=maxiters, axis=axis, cenfunc=cenfunc,
                           stdfunc=stdfunc)
    mean, std = masked_mean_std(x, keep, axis=axis)
    median = masked_median(x, keep, axis=axis)
    if stdfunc == "mad_std":
        std = mad_std(x, keep, axis=axis)
    return mean, median, std
