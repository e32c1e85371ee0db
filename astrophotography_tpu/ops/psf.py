"""Batched 2-D Gaussian PSF fitting by Levenberg-Marquardt.

Device-native replacement for the reference's per-star scipy LevMar fits
(reference core/ApMeasureStars.py:223-430: staged Gaussian2D + Const2D
fits with weights 1/sqrt(counts), reduced chi^2, FWHM = 2.35482*sigma,
axial ratio and 3-sigma circularity test).  All stars fit at once:
fixed-size cutouts stacked into an (N, M, M) tensor, a fixed-iteration
LM loop with per-star damping, and a 7x7 normal-equation solve vmapped
across the batch.

Also provides the isolation filter the reference runs through a scipy
KDTree (core/ApMeasureStars.py:952-1003) as a brute-force O(N^2)
pairwise distance computation — trivial at N <= 10^4 on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

FWHM_PER_SIGMA = 2.35482

#: full f32 normal equations: a reduced-precision (TF32) J^T J keeps
#: only ~3 decimal digits, too few for the LM solve
_HIGHEST = jax.lax.Precision.HIGHEST


class PSFFits(NamedTuple):
    """Per-star fit results (fixed capacity)."""

    amplitude: jnp.ndarray
    x0: jnp.ndarray            # absolute image coords
    y0: jnp.ndarray
    fwhm_x: jnp.ndarray
    fwhm_y: jnp.ndarray
    theta: jnp.ndarray
    background: jnp.ndarray
    chi2_red: jnp.ndarray
    fwhm_x_err: jnp.ndarray
    fwhm_y_err: jnp.ndarray
    axial_ratio: jnp.ndarray   # max/min fwhm, >= 1
    circular: jnp.ndarray      # bool: |fx-fy| < 3*sqrt(errx^2+erry^2)
    valid: jnp.ndarray


def extract_cutouts(
    data: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    box: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(N, box, box) cutout stack centred (to the pixel) on each star.

    Returns (cutouts, x_origin, y_origin) — reference _extract_cutouts
    (core/ApMeasureStars.py:492-514).
    """
    h, w = data.shape
    half = box // 2

    def one(cx, cy):
        iy = jnp.clip(jnp.round(cy).astype(jnp.int32) - half, 0, h - box)
        ix = jnp.clip(jnp.round(cx).astype(jnp.int32) - half, 0, w - box)
        return jax.lax.dynamic_slice(data, (iy, ix), (box, box)), ix, iy

    cuts, ixs, iys = jax.vmap(one)(x, y)
    return cuts, ixs, iys


def _gauss2d(params, xx, yy):
    amp, x0, y0, sx, sy, theta, bg = params
    sx = jnp.maximum(sx, 0.3)
    sy = jnp.maximum(sy, 0.3)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    a = ct ** 2 / (2 * sx ** 2) + st ** 2 / (2 * sy ** 2)
    b = st * ct * (1.0 / (2 * sx ** 2) - 1.0 / (2 * sy ** 2))
    c = st ** 2 / (2 * sx ** 2) + ct ** 2 / (2 * sy ** 2)
    dx = xx - x0
    dy = yy - y0
    return amp * jnp.exp(-(a * dx * dx + 2 * b * dx * dy + c * dy * dy)) + bg


@functools.partial(jax.jit, static_argnames=("box", "iters"))
def fit_gaussian2d(
    cutouts: jnp.ndarray,
    valid: jnp.ndarray,
    x_origin: jnp.ndarray,
    y_origin: jnp.ndarray,
    init_fwhm: float = 3.0,
    box: int = 16,
    iters: int = 40,
) -> PSFFits:
    """LM-fit Gaussian2D+Const2D to every cutout simultaneously.

    Weights are 1/sqrt(max(counts,1)) as in the reference
    (core/ApMeasureStars.py:318-331); iteration count is fixed with
    per-star acceptance masks (jittable convergence).
    """
    n = cutouts.shape[0]
    cutouts = cutouts.astype(jnp.float32)
    ys = jnp.arange(box, dtype=jnp.float32)
    xs = jnp.arange(box, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(xs, ys)

    wgt = 1.0 / jnp.sqrt(jnp.maximum(cutouts, 1.0))

    # initial parameters per star
    bg0 = jnp.median(cutouts, axis=(1, 2))
    amp0 = jnp.max(cutouts, axis=(1, 2)) - bg0
    sig0 = jnp.float32(init_fwhm / FWHM_PER_SIGMA)
    half = (box - 1) / 2.0
    # centroid of bg-subtracted counts for initial position
    pos = jnp.maximum(cutouts - bg0[:, None, None], 0.0)
    tot = jnp.maximum(jnp.sum(pos, axis=(1, 2)), 1e-9)
    cx0 = jnp.sum(pos * xx[None], axis=(1, 2)) / tot
    cy0 = jnp.sum(pos * yy[None], axis=(1, 2)) / tot
    params0 = jnp.stack([
        amp0, cx0, cy0,
        jnp.full((n,), sig0), jnp.full((n,), sig0),
        jnp.zeros(n), bg0], axis=1)  # (N, 7)

    def residuals(params, cut, w):
        model = _gauss2d(params, xx, yy)
        return ((cut - model) * w).reshape(-1)

    def cost(params, cut, w):
        r = residuals(params, cut, w)
        return jnp.sum(r * r)

    jac_fn = jax.jacfwd(residuals)

    def lm_step(state, _):
        params, lam = state

        def one(p, l, cut, w):
            r = residuals(p, cut, w)
            J = jac_fn(p, cut, w)            # (M², 7)
            g = jnp.matmul(J.T, r, precision=_HIGHEST)  # grad of 0.5*|r|²
            H = jnp.matmul(J.T, J, precision=_HIGHEST)
            Hd = H + l * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7)
            delta = jnp.linalg.solve(Hd, g)
            new_p = p - delta  # descend: minimize |r|^2 with J = dr/dp
            old_c = jnp.sum(r * r)
            new_c = cost(new_p, cut, w)
            accept = new_c < old_c
            p_out = jnp.where(accept, new_p, p)
            l_out = jnp.where(accept, jnp.maximum(l * 0.33, 1e-7),
                              jnp.minimum(l * 4.0, 1e6))
            return p_out, l_out

        new_params, new_lam = jax.vmap(one)(params, lam, cutouts, wgt)
        return (new_params, new_lam), None

    (params, _lam), _ = jax.lax.scan(
        lm_step, (params0, jnp.full((n,), 1e-3)), None, length=iters)

    # covariance from final Gauss-Newton Hessian, scaled by reduced chi2
    def final_stats(p, cut, w):
        r = residuals(p, cut, w)
        J = jac_fn(p, cut, w)
        H = jnp.matmul(J.T, J, precision=_HIGHEST) + 1e-8 * jnp.eye(7)
        cov = jnp.linalg.inv(H)
        dof = box * box - 7
        chi2r = jnp.sum(r * r) / dof
        perr = jnp.sqrt(jnp.maximum(jnp.diag(cov) * chi2r, 0.0))
        return chi2r, perr

    chi2r, perr = jax.vmap(final_stats)(params, cutouts, wgt)

    amp, cx, cy, sx, sy, theta, bg = [params[:, i] for i in range(7)]
    sx = jnp.abs(sx)
    sy = jnp.abs(sy)
    fwhm_x = FWHM_PER_SIGMA * sx
    fwhm_y = FWHM_PER_SIGMA * sy
    fx_err = FWHM_PER_SIGMA * perr[:, 3]
    fy_err = FWHM_PER_SIGMA * perr[:, 4]
    big = jnp.maximum(fwhm_x, fwhm_y)
    small = jnp.minimum(fwhm_x, fwhm_y)
    axial = big / jnp.maximum(small, 1e-6)
    # circularity: FWHMs consistent within 3 sigma
    # (reference core/ApMeasureStars.py:401-420,432-445)
    circ = jnp.abs(fwhm_x - fwhm_y) < 3.0 * jnp.sqrt(fx_err ** 2 + fy_err ** 2)
    ok = valid & (amp > 0) & jnp.isfinite(chi2r)
    return PSFFits(
        amplitude=amp,
        x0=cx + x_origin.astype(jnp.float32),
        y0=cy + y_origin.astype(jnp.float32),
        fwhm_x=fwhm_x,
        fwhm_y=fwhm_y,
        theta=theta,
        background=bg,
        chi2_red=chi2r,
        fwhm_x_err=fx_err,
        fwhm_y_err=fy_err,
        axial_ratio=axial,
        circular=circ,
        valid=ok,
    )


def measure_fwhm(
    data: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    valid: jnp.ndarray,
    init_fwhm: float = 3.0,
    box: int = 16,
) -> PSFFits:
    """Convenience: cutouts + batched fit at the given star positions."""
    cuts, ixs, iys = extract_cutouts(data, x.astype(jnp.float32),
                                     y.astype(jnp.float32), box)
    return fit_gaussian2d(cuts, valid, ixs, iys, init_fwhm=init_fwhm, box=box)


@jax.jit
def nearest_neighbor_dist(
    x: jnp.ndarray, y: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Distance to each star's nearest valid neighbor (brute force O(N²),
    the KDTree replacement — reference core/ApMeasureStars.py:963-998)."""
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    d2 = dx * dx + dy * dy
    pairmask = valid[None, :] & valid[:, None]
    n = x.shape[0]
    d2 = jnp.where(pairmask & ~jnp.eye(n, dtype=bool), d2, jnp.inf)
    return jnp.sqrt(jnp.min(d2, axis=1))


def isolated_mask(
    x: jnp.ndarray, y: jnp.ndarray, valid: jnp.ndarray, min_sep: float
) -> jnp.ndarray:
    """True for stars whose nearest neighbor is at least min_sep away
    (the reference drops stars with a neighbor inside the fit box width)."""
    return valid & (nearest_neighbor_dist(x, y, valid) >= min_sep)


def median_fwhm(fits: PSFFits, sigma: float = 3.0):
    """Sigma-clipped median FWHM (x and y) over accepted fits
    (reference median_fwhm, core/ApMeasureStars.py:1006-1039: 3-sigma
    clip about the median with MAD-std deviation).

    Returns ((med_fx, madstd_fx), (med_fy, madstd_fy)).
    """
    from .stats import mad_std, masked_median, sigma_clip_mask

    out = []
    for vals in (fits.fwhm_x, fits.fwhm_y):
        keep = sigma_clip_mask(vals, fits.valid, sigma_lower=sigma,
                               sigma_upper=sigma, maxiters=5,
                               cenfunc="median", stdfunc="mad_std")
        med = masked_median(vals, keep)
        std = mad_std(vals, keep)
        out.append((med, std))
    return tuple(out)
