"""Frame-to-frame registration: star pattern matching + similarity solve.

The reference has no local registration — frames are aligned by swarp
using WCS solutions from the astrometry.net web service
(reference scripts/resample_all.sh:330-342, core/ApAstrometry.py).  This
rebuild registers frames to a reference frame directly from their
star tables (SURVEY.md §2.5 "astrometry.net" row), so stacking never
needs the network.

Method (all fixed-shape, jittable):

1. take the top-K brightest stars of each frame;
2. candidate transforms from every ordered star-pair in the reference
   frame vs every ordered pair in the target (scale+rotation from the
   segment, translation from the first endpoint), gated to plausible
   scale;
3. score every candidate by inlier count on the K x K cross-distance
   matrix (RANSAC with exhaustive pair hypotheses instead of random
   sampling — deterministic and massively parallel);
4. least-squares similarity refit (Umeyama/Procrustes closed form) on
   the inlier matching of the best candidate, iterated once.

Convention: the returned transform maps REFERENCE frame coordinates to
TARGET frame coordinates: x_tgt = s*R @ x_ref + t.  Warping the target
onto the reference grid then uses this directly as the inverse map.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


#: translation sentinel marking a REJECTED registration solve (see the
#: degeneracy gate in estimate_similarity); callers detecting rejected
#: frames must compare against this, not a magic number
REJECTED_TRANSLATION = 1e9


class Similarity(NamedTuple):
    """x' = scale * R(theta) @ x + (tx, ty)."""

    scale: jnp.ndarray
    theta: jnp.ndarray
    tx: jnp.ndarray
    ty: jnp.ndarray
    n_inliers: jnp.ndarray
    rms: jnp.ndarray            # inlier residual rms (pixels)

    def matrix(self) -> jnp.ndarray:
        """(2, 3) matrix [A | t] with x' = A @ x + t."""
        c = self.scale * jnp.cos(self.theta)
        s = self.scale * jnp.sin(self.theta)
        return jnp.array([[c, -s, self.tx], [s, c, self.ty]])

    def apply(self, x: jnp.ndarray, y: jnp.ndarray):
        c = self.scale * jnp.cos(self.theta)
        s = self.scale * jnp.sin(self.theta)
        return c * x - s * y + self.tx, s * x + c * y + self.ty

    def inverse(self) -> "Similarity":
        inv_scale = 1.0 / self.scale
        c = jnp.cos(-self.theta) * inv_scale
        s = jnp.sin(-self.theta) * inv_scale
        tx = -(c * self.tx - s * self.ty)
        ty = -(s * self.tx + c * self.ty)
        return Similarity(inv_scale, -self.theta, tx, ty,
                          self.n_inliers, self.rms)


def _top_k_stars(x, y, flux, valid, k):
    score = jnp.where(valid, flux, -jnp.inf)
    _, idx = jax.lax.top_k(score, k)
    ok = jnp.take(valid, idx)
    return jnp.take(x, idx), jnp.take(y, idx), ok


def solve_similarity(
    src_xy: jnp.ndarray,
    dst_xy: jnp.ndarray,
    weights: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Weighted closed-form similarity fit src -> dst (Umeyama).

    Returns (scale, theta, tx, ty)."""
    w = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    mu_s = jnp.sum(src_xy * w[:, None], axis=0)
    mu_d = jnp.sum(dst_xy * w[:, None], axis=0)
    sc = src_xy - mu_s
    dc = dst_xy - mu_d
    # complex-number formulation of 2-D similarity: z' = a z + b
    a_num = jnp.sum(w * (dc[:, 0] * sc[:, 0] + dc[:, 1] * sc[:, 1])), \
        jnp.sum(w * (dc[:, 1] * sc[:, 0] - dc[:, 0] * sc[:, 1]))
    denom = jnp.maximum(jnp.sum(w * (sc[:, 0] ** 2 + sc[:, 1] ** 2)), 1e-12)
    re = a_num[0] / denom
    im = a_num[1] / denom
    scale = jnp.sqrt(re * re + im * im)
    theta = jnp.arctan2(im, re)
    c = scale * jnp.cos(theta)
    s = scale * jnp.sin(theta)
    tx = mu_d[0] - (c * mu_s[0] - s * mu_s[1])
    ty = mu_d[1] - (s * mu_s[0] + c * mu_s[1])
    return scale, theta, tx, ty


@functools.partial(jax.jit,
                   static_argnames=("k", "refine_iters"))
def estimate_similarity(
    ref_x: jnp.ndarray, ref_y: jnp.ndarray, ref_flux: jnp.ndarray,
    ref_valid: jnp.ndarray,
    tgt_x: jnp.ndarray, tgt_y: jnp.ndarray, tgt_flux: jnp.ndarray,
    tgt_valid: jnp.ndarray,
    k: int = 16,
    scale_tol: float = 0.1,
    inlier_tol: float = 2.0,
    min_seg: float = 10.0,
    refine_iters: int = 2,
) -> Similarity:
    """Estimate the similarity mapping ref coords to tgt coords."""
    rx, ry, rv = _top_k_stars(ref_x, ref_y, ref_flux, ref_valid, k)
    tx_, ty_, tv = _top_k_stars(tgt_x, tgt_y, tgt_flux, tgt_valid, k)

    def segments(x, y, v):
        dx = x[None, :] - x[:, None]
        dy = y[None, :] - y[:, None]
        length = jnp.sqrt(dx * dx + dy * dy)
        ang = jnp.arctan2(dy, dx)
        ok = (v[:, None] & v[None, :] & (length > min_seg))
        return length, ang, ok

    rlen, rang, rok = segments(rx, ry, rv)
    tlen, tang, tok = segments(tx_, ty_, tv)

    # candidate transforms: ref pair (i,j) matched to tgt pair (p,q)
    # flatten pairs
    rlen_f = rlen.reshape(-1)
    rang_f = rang.reshape(-1)
    rok_f = rok.reshape(-1)
    tlen_f = tlen.reshape(-1)
    tang_f = tang.reshape(-1)
    tok_f = tok.reshape(-1)
    ri = jnp.repeat(jnp.arange(k), k)       # first endpoint of ref pair
    ti = jnp.repeat(jnp.arange(k), k)

    n_pairs = k * k
    scale_c = tlen_f[None, :] / jnp.maximum(rlen_f[:, None], 1e-9)   # (P, P)
    theta_c = tang_f[None, :] - rang_f[:, None]
    cand_ok = (rok_f[:, None] & tok_f[None, :]
               & (jnp.abs(scale_c - 1.0) < scale_tol))
    c_c = scale_c * jnp.cos(theta_c)
    s_c = scale_c * jnp.sin(theta_c)
    rx_i = rx[ri][:, None]
    ry_i = ry[ri][:, None]
    tx_i = tx_[ti][None, :]
    ty_i = ty_[ti][None, :]
    tx_c = tx_i - (c_c * rx_i - s_c * ry_i)
    ty_c = ty_i - (s_c * rx_i + c_c * ry_i)

    # score candidates: count ref stars that land within tol of any tgt
    # star.  The candidate axis is kept MINOR (contiguous): a
    # per-candidate vmap over (k, k) distance matrices leaves every tiny
    # row mostly padding; candidates-minor gives each elementwise op
    # long contiguous runs.  Chunked so the (k, k, C)
    # temporary stays bounded under the frame vmap.
    flat_c = c_c.reshape(-1)
    flat_s = s_c.reshape(-1)
    flat_tx = tx_c.reshape(-1)
    flat_ty = ty_c.reshape(-1)
    flat_ok = cand_ok.reshape(-1)
    n_cand = n_pairs * n_pairs
    chunk = min(n_cand, max(512, (131072 // (k * k)) // 128 * 128))
    pad = (-n_cand) % chunk
    if pad:
        flat_c = jnp.pad(flat_c, (0, pad), constant_values=1.0)
        flat_s = jnp.pad(flat_s, (0, pad))
        flat_tx = jnp.pad(flat_tx, (0, pad))
        flat_ty = jnp.pad(flat_ty, (0, pad))
    pair_ok = (rv[:, None] & tv[None, :])[..., None]

    def score_chunk(cc, sc, txc, tyc):
        mx = cc[None, :] * rx[:, None] - sc[None, :] * ry[:, None] \
            + txc[None, :]                                   # (k, C)
        my = sc[None, :] * rx[:, None] + cc[None, :] * ry[:, None] \
            + tyc[None, :]
        d2 = ((mx[:, None, :] - tx_[None, :, None]) ** 2
              + (my[:, None, :] - ty_[None, :, None]) ** 2)  # (k, k, C)
        d2 = jnp.where(pair_ok, d2, jnp.inf)
        return jnp.sum(jnp.min(d2, axis=1) < inlier_tol ** 2,
                       axis=0).astype(jnp.int32)             # (C,)

    scores = jnp.concatenate([
        score_chunk(flat_c[o:o + chunk], flat_s[o:o + chunk],
                    flat_tx[o:o + chunk], flat_ty[o:o + chunk])
        for o in range(0, n_cand + pad, chunk)])[:n_cand]
    scores = jnp.where(flat_ok, scores, -1)
    flat_c = flat_c[:n_cand]
    flat_s = flat_s[:n_cand]
    flat_tx = flat_tx[:n_cand]
    flat_ty = flat_ty[:n_cand]
    best = jnp.argmax(scores)
    c_b, s_b = flat_c[best], flat_s[best]
    tx_b, ty_b = flat_tx[best], flat_ty[best]

    # refinement over EVERY valid star (the candidate search above uses
    # only the k brightest; centroid errors average down with the
    # number of matched stars): nearest-neighbor matching under the
    # current transform + weighted closed-form refit
    def refine(carry, _):
        c, s, tx0, ty0 = carry
        mx = c * ref_x - s * ref_y + tx0
        my = s * ref_x + c * ref_y + ty0
        d2 = ((mx[:, None] - tgt_x[None, :]) ** 2
              + (my[:, None] - tgt_y[None, :]) ** 2)
        d2 = jnp.where(ref_valid[:, None] & tgt_valid[None, :], d2, jnp.inf)
        nn = jnp.argmin(d2, axis=1)
        nn_d2 = jnp.min(d2, axis=1)
        wgt = (nn_d2 < inlier_tol ** 2).astype(jnp.float32)
        src = jnp.stack([ref_x, ref_y], axis=1)
        dst = jnp.stack([jnp.take(tgt_x, nn), jnp.take(tgt_y, nn)], axis=1)
        scale, theta, tx1, ty1 = solve_similarity(src, dst, wgt)
        return (scale * jnp.cos(theta), scale * jnp.sin(theta), tx1, ty1), \
            (wgt, nn_d2, nn)

    (c_f, s_f, tx_f, ty_f), (wgts, dists, nns) = jax.lax.scan(
        refine, (c_b, s_b, tx_b, ty_b), None, length=refine_iters)
    last_w = wgts[-1]
    last_d2 = dists[-1]
    last_nn = nns[-1]
    # count DISTINCT matched target stars: a degenerate collapsing
    # transform can drag many ref stars within tolerance of ONE target
    # (e.g. a single-star frame), which would otherwise masquerade as a
    # well-supported solution
    n_in = jnp.sum(jnp.zeros(tgt_x.shape, jnp.float32)
                   .at[last_nn].max(last_w))
    rms = jnp.sqrt(jnp.sum(jnp.where(last_w > 0, last_d2, 0.0))
                   / jnp.maximum(n_in, 1.0))
    scale_f = jnp.sqrt(c_f * c_f + s_f * s_f)
    theta_f = jnp.arctan2(s_f, c_f)
    # a similarity needs >= 2 inliers; below that the LSQ collapses to
    # a degenerate (e.g. scale-0) transform that maps everything to one
    # IN-RANGE source point — downstream coverage tests would then
    # accept a garbage constant frame into the stack.  Return a
    # unit-scale transform translated far outside any frame instead:
    # coverage then excludes the frame everywhere (the reference's bash
    # flow likewise drops frames whose solve fails), and callers can
    # diagnose via n_inliers.
    ok = (n_in >= 2) & (jnp.abs(scale_f - 1.0) < 3.0 * scale_tol)
    far = jnp.float32(REJECTED_TRANSLATION)
    return Similarity(
        scale=jnp.where(ok, scale_f, 1.0),
        theta=jnp.where(ok, theta_f, 0.0),
        tx=jnp.where(ok, tx_f, far),
        ty=jnp.where(ok, ty_f, far),
        n_inliers=n_in.astype(jnp.int32), rms=rms)
