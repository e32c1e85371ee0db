"""Sigma-clipped stack combination over a frame axis.

Device-native equivalent of ccdproc.combine as invoked by the master
calibration builder (reference scripts/ap_combine_darks.py:388-420:
method='average', sigma_clip low/high = 5, center = masked median,
deviation = mad_std, RAM-chunked via mem_limit).  Here the stack lives
on-device as an (N, H, W) tensor and the clip + reduce is one XLA
computation; chip-count scaling shards the frame axis (parallel/).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .stats import masked_mean_std, masked_median, sigma_clip_mask


@functools.partial(
    jax.jit,
    static_argnames=("method", "sigma_lower", "sigma_upper", "maxiters"))
def sigma_clip_combine(
    stack: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    weights: Optional[jnp.ndarray] = None,
    method: str = "average",
    sigma_lower: float = 5.0,
    sigma_upper: float = 5.0,
    maxiters: int = 1,
) -> jnp.ndarray:
    """Combine an (N, ...) stack along axis 0 with per-pixel sigma clipping.

    * clip: |x - median| vs sigma * mad_std per pixel column
      (ccdproc's sigma_clip_func=np.ma.median, dev_func=mad_std;
      reference scripts/ap_combine_darks.py:411-416); ccdproc applies a
      single clipping pass, hence maxiters=1 by default.
    * combine: masked mean ('average'), masked median ('median'), or
      masked sum ('sum'); optional per-frame weights (N,) for
      'average', matching swarp's WEIGHTED co-addition role
      (reference scripts/resample_all.sh:62-79).
    """
    stack = stack.astype(jnp.float32)
    keep = jnp.ones_like(stack, bool) if mask is None else mask
    if maxiters == 1:
        # fused fast path: exactly two sorts (median + MAD) and
        # elementwise work — the general path re-sorts per statistic
        med = masked_median(stack, keep, axis=0)
        dev = jnp.abs(stack - med[None])
        mad = masked_median(dev, keep, axis=0)
        std = 1.482602218505602 * mad
        keep = keep & (stack >= (med - sigma_lower * std)[None]) \
            & (stack <= (med + sigma_upper * std)[None])
    else:
        keep = sigma_clip_mask(stack, keep, sigma_lower=sigma_lower,
                               sigma_upper=sigma_upper, maxiters=maxiters,
                               axis=0, cenfunc="median", stdfunc="mad_std")
    if method == "median":
        return masked_median(stack, keep, axis=0)
    if method == "sum":
        return jnp.sum(jnp.where(keep, stack, 0.0), axis=0)
    if method == "average":
        if weights is None:
            mean, _ = masked_mean_std(stack, keep, axis=0)
            return mean
        w = weights.astype(jnp.float32).reshape((-1,) + (1,) * (stack.ndim - 1))
        wm = jnp.where(keep, w, 0.0)
        denom = jnp.sum(wm, axis=0)
        return jnp.sum(stack * wm, axis=0) / jnp.maximum(denom, 1e-30)
    raise ValueError(f"unknown combine method {method!r}")
