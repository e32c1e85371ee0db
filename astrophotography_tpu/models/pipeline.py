"""The flagship device pipeline: calibrate -> detect -> register -> warp
-> sigma-clip stack, fused as one jitted computation over a
device-resident frame batch.

The reference runs the same chain as five separate processes writing
FITS between stages (ap_calibrate -> ap_find_stars -> ap_astrometry
network solve -> swarp resample -> combine; SURVEY.md §3.5), one frame
at a time.  Here the (N, H, W) stack stays on device end-to-end and
every stage is batched: calibration broadcasts masters over the frame
axis, detection vmaps the matched filter, registration solves all
frame->reference similarities in parallel from the star tables, warping
vmaps the Lanczos3 kernel, and the stack combine is a per-pixel masked
sigma-clip reduce.

Multi-device: frames shard over the mesh for calibrate/detect/warp
(embarrassingly parallel); XLA re-shards to the spatial axis for the
cross-frame combine (an all-to-all) when the caller jits this function
under a Mesh with sharded inputs (see parallel/).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.calibrate import calibrate_batch
from ..ops.detect import find_stars
from ..ops.register import Similarity, estimate_similarity
from ..ops.stack import sigma_clip_combine
from ..ops.warp import (warp_affine_bilinear, warp_affine_lanczos3,
                        warp_affine_separable)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the fused pipeline (hashable for jit)."""

    fwhm: float = 3.0
    detect_nsigma: float = 7.0
    max_stars: int = 64
    match_k: int = 12
    sigma_lower: float = 5.0
    sigma_upper: float = 5.0
    combine: str = "average"
    #: 'separable' = gather-free two-pass Lanczos3 (shift budget
    #: ``warp_span``), 'lanczos3' = direct 6x6 gather kernel (any
    #: affine), 'bilinear' = cheap preview
    interp: str = "separable"
    #: shift budget of the separable warp: it resamples exactly while
    #: |m10|*W <= warp_span - 6 (ops/warp.warp_affine_separable) -- 12
    #: covers the rotations of dithered same-rig stacks (~0.08 deg at
    #: 4k width); raise it for larger field rotations and mosaics
    warp_span: int = 12
    dark_still_biased: bool = True
    #: number of horizontal bands the warp+combine streams over.  1 =
    #: whole-stack at once (fastest when it fits); larger values bound
    #: peak device memory to ~(stack + N*H/n_bands*W) instead of several
    #: full (N, H, W) temporaries
    n_bands: int = 1
    #: detection across frames: 'vmap' (parallel, one density stack) or
    #: 'chunked' (chunks of detect_chunk frames behind optimization
    #: barriers, an inner vmap each -- bounds memory without per-frame
    #: dispatch overhead)
    detect_mode: str = "vmap"
    detect_chunk: int = 8
    #: peak ranking: 'global' (exact full-image top_k) or 'tile'
    #: (strongest peak per 64x256 tile -- far fewer candidates to rank;
    #: registration fields lose only same-tile neighbors)
    detect_topk: str = "global"
    #: registration reference frame: an index, or 'auto' to pick the
    #: frame with the most detected stars (the reference workflow picks
    #: reference frames from the quality report; a bad frame 0 would
    #: otherwise degrade the whole stack)
    ref_frame: "int | str" = 0
    #: matched filter: False = exact DAOFIND circular-footprint f32;
    #: True = separable square-footprint bf16 (registration-grade;
    #: ops/detect._fast_density)
    detect_fast: bool = False
    #: with detect_fast: run the density/peak search on 2x row-binned
    #: data (halves detection cost; centroids stay full-resolution)
    detect_bin_rows: bool = False
    #: detection-threshold noise center: 'mean' (3-iter clipped mean,
    #: sort-free; tracks the median to <0.06 sigma, bounded in tests) or
    #: 'median' (exact sigma_clipped_stats semantics, reference
    #: ApFindStars.py:142-154)
    noise_center: str = "mean"

    def __post_init__(self):
        # catch typos up front: a misspelled mode would otherwise fall
        # through to a default path silently
        if self.noise_center not in ("mean", "median"):
            raise ValueError(f"PipelineConfig.noise_center must be 'mean' "
                             f"or 'median', got {self.noise_center!r}")


def _noise_row_stride(h: int) -> int:
    """Row stride for the noise-stat subsample: ~64 full rows on large
    frames (>= 256k px/frame at 4k width — std error ~0.1%, far below
    the nsigma threshold's sensitivity), denser on small frames so
    tiny test images keep a meaningful sample."""
    return max(8, min(64, h // 64))


def _sample_rows(x: jnp.ndarray, st: int) -> jnp.ndarray:
    """Every st-th row of an (..., H, W) array — x[..., ::st, :] values.

    NOT written as a strided slice: on a (100, 4096, 4096) stack XLA
    can lower ``x[:, ::st, :]`` to a gather behind a full-stack layout
    copy; the reshape+unit-slice form lowers to a plain windowed
    slice."""
    h = x.shape[-2]
    if h % st:
        return x[..., ::st, :]
    shp = x.shape[:-2] + (h // st, st, x.shape[-1])
    return x.reshape(shp)[..., 0, :]


@functools.partial(jax.jit, static_argnames=("center",))
def frame_noise_stats(frames: jnp.ndarray,
                      center: str = "mean") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-frame (center, robust std) for detection thresholds, on a
    row-subsampled grid (:func:`_noise_row_stride`).  Rows only: full
    contiguous rows read at full memory bandwidth and are a larger
    sample than a 2-D stride grid.

    ``center='mean'`` (default): 3 iterations of mean/std clipping — no
    sorts in the hot path; the clipped mean tracks the median to
    <0.06 sigma even on unrealistically dense star fields (bounded in
    tests/test_accuracy_bounds.py).  ``center='median'``: exact
    sigma_clipped_stats median/std semantics (the reference's
    ApFindStars.py:142-154), one full sort of the subsample per frame.
    """
    st = _noise_row_stride(frames.shape[1])
    sub = _sample_rows(frames, st).reshape(frames.shape[0], -1)
    if center == "median":
        from ..ops.stats import sigma_clipped_stats

        _mean_unused, med, std = sigma_clipped_stats(
            sub, sigma=3.0, maxiters=3, axis=1)
        return med, std
    keep = jnp.ones_like(sub, bool)
    cen = jnp.mean(sub, axis=1)
    std = jnp.std(sub, axis=1)
    for _ in range(3):
        cen = jnp.sum(jnp.where(keep, sub, 0), axis=1) \
            / jnp.maximum(jnp.sum(keep, axis=1), 1)
        var = jnp.sum(jnp.where(keep, (sub - cen[:, None]) ** 2, 0), axis=1) \
            / jnp.maximum(jnp.sum(keep, axis=1), 1)
        std = jnp.sqrt(var)
        keep = keep & (jnp.abs(sub - cen[:, None]) < 3.0 * std[:, None])
    return cen, std


def _ref_index(stars, config: PipelineConfig):
    """Registration reference frame index: a fixed index, or 'auto' =
    the frame with the most detected stars (the reference workflow picks
    reference frames from the quality report rather than blindly using
    the first light; see ApQualitySummarizer usage in SURVEY.md)."""
    if config.ref_frame == "auto":
        return jnp.argmax(jnp.sum(stars.valid, axis=1))
    # validate on the host: JAX gather would silently CLAMP any
    # out-of-range index to an unintended frame
    n = stars.valid.shape[0]
    idx = int(config.ref_frame)
    if not -n <= idx < n:
        raise ValueError(f"ref_frame {idx} out of range for {n} frames")
    return jnp.int32(idx % n)


def _solve_frame_similarities(stars, n: int, config: PipelineConfig):
    """Reference-frame choice + per-frame similarity solves + exact
    identity overwrite for the chosen reference — the post-detection
    half of :func:`register_frames`."""
    idx_ref = _ref_index(stars, config)
    ref = jax.tree_util.tree_map(lambda a: a[idx_ref], stars)

    def est(i):
        tgt = jax.tree_util.tree_map(lambda a: a[i], stars)
        return estimate_similarity(
            ref.x, ref.y, ref.flux, ref.valid,
            tgt.x, tgt.y, tgt.flux, tgt.valid, k=config.match_k)

    sims = jax.vmap(est)(jnp.arange(n))
    ident = Similarity(
        scale=jnp.ones(()), theta=jnp.zeros(()), tx=jnp.zeros(()),
        ty=jnp.zeros(()), n_inliers=jnp.int32(config.max_stars),
        rms=jnp.zeros(()))
    sims = jax.tree_util.tree_map(
        lambda all_v, id_v: all_v.at[idx_ref].set(id_v), sims,
        jax.tree_util.tree_map(lambda x: jnp.asarray(x), ident))
    matrices = jax.vmap(lambda i: jax.tree_util.tree_map(
        lambda a: a[i], sims).matrix())(jnp.arange(n))
    return sims, matrices, idx_ref


@functools.partial(jax.jit, static_argnames=("config",))
def register_frames(
    cal: jnp.ndarray,
    config: PipelineConfig = PipelineConfig(),
):
    """Detect stars and solve all frame->reference similarities for an
    (N, H, W) CALIBRATED stack — the registration half of the fused
    pipeline, reusable standalone (e.g. for union-canvas/mosaic
    stacking where the output geometry is computed on the host between
    the registration and stacking passes).

    Returns (stars, sims, matrices (N, 2, 3), ref_idx)."""
    n = cal.shape[0]
    with jax.named_scope("noise_stats"):
        center, std = frame_noise_stats(cal, center=config.noise_center)

    def detect(frame, c, s):
        # floor=c instead of frame - c: the matched filter is
        # DC-invariant, so the subtracted copy never materializes
        return find_stars(frame, fwhm=config.fwhm,
                          threshold=config.detect_nsigma * s,
                          max_stars=config.max_stars,
                          topk_mode=config.detect_topk,
                          mode="fast" if config.detect_fast else "exact",
                          stats=False,  # registration needs x/y/flux only
                          bin_rows=config.detect_bin_rows, floor=c)

    with jax.named_scope("detect"):
        if config.detect_mode == "chunked" and n > config.detect_chunk:
            c = config.detect_chunk
            if n % c:
                raise ValueError(f"frame count {n} not divisible by "
                                 f"detect_chunk {c}")
            parts = []
            token = jnp.float32(0.0)
            for k in range(0, n, c):
                chunk, _tok = jax.lax.optimization_barrier(
                    (cal[k:k + c], token))
                part = jax.vmap(detect)(chunk, center[k:k + c],
                                        std[k:k + c])
                token = jax.lax.optimization_barrier(part.x[0, 0])
                parts.append(part)
            stars = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *parts)
        else:
            stars = jax.vmap(detect)(cal, center, std)

    with jax.named_scope("register"):
        sims, matrices, ref_idx = _solve_frame_similarities(stars, n,
                                                            config)
    return stars, sims, matrices, ref_idx


@functools.partial(jax.jit, static_argnames=("config",))
def stack_registered(
    cal: jnp.ndarray,
    matrices: jnp.ndarray,
    config: PipelineConfig = PipelineConfig(),
) -> jnp.ndarray:
    """Warp every frame of a calibrated (N, H, W) stack onto the
    reference grid with its (N, 2, 3) output->input matrix and
    sigma-clip combine — the stacking half of
    :func:`calibrate_register_stack`.  Output pixels no frame covers
    are 0."""
    h, w = cal.shape[1:]
    if config.interp == "separable":
        # analytic coverage: the stacking path masks coverage<0.5 anyway,
        # so skipping the warped ones-channel halves warp work at the
        # cost of a few excluded border pixels
        warp = functools.partial(warp_affine_separable,
                                 span=config.warp_span,
                                 analytic_coverage=True)
    else:
        warp = {"lanczos3": warp_affine_lanczos3,
                "bilinear": warp_affine_bilinear}[config.interp]

    def warp_and_combine(mats, band_h):
        """Warp every frame onto one output band and combine it."""
        with jax.named_scope("warp"):
            warped, weights = jax.vmap(
                lambda f, m: warp(f, m, (band_h, w)))(cal, mats)
        with jax.named_scope("combine"):
            out = sigma_clip_combine(
                warped, mask=weights > 0.5,
                sigma_lower=config.sigma_lower,
                sigma_upper=config.sigma_upper,
                method=config.combine)
            # border pixels covered by no frame are 0 (swarp weight-map
            # semantics), not NaN
            return jnp.where(jnp.isnan(out), 0.0, out)

    if config.n_bands <= 1:
        stacked = warp_and_combine(matrices, h)
    else:
        if h % config.n_bands:
            raise ValueError(f"height {h} not divisible by n_bands "
                             f"{config.n_bands}")
        band_h = h // config.n_bands
        # shift each band's output grid by adjusting the translation:
        # out (x, y+y0) -> input coords adds A @ (0, y0) to t
        y0s = jnp.arange(config.n_bands, dtype=jnp.float32) * band_h

        def band_mats(y0):
            shift = jnp.stack([matrices[:, 0, 1] * y0,
                               matrices[:, 1, 1] * y0], axis=1)
            return matrices.at[:, :, 2].add(shift)

        bands = jax.lax.map(
            lambda y0: warp_and_combine(band_mats(y0), band_h), y0s)
        stacked = bands.reshape(h, w)
    return stacked


@functools.partial(jax.jit, static_argnames=("config",))
def calibrate_register_stack(
    frames: jnp.ndarray,
    bias: Optional[jnp.ndarray] = None,
    dark: Optional[jnp.ndarray] = None,
    flat: Optional[jnp.ndarray] = None,
    exp_ratios: Optional[jnp.ndarray] = None,
    badpix_mask: Optional[jnp.ndarray] = None,
    flux_scales: Optional[jnp.ndarray] = None,
    config: PipelineConfig = PipelineConfig(),
):
    """Full fused pipeline over an (N, H, W) stack; ``config.ref_frame``
    picks the registration reference.

    ``flux_scales`` (N,) multiplies each calibrated frame before
    stacking — the swarp FSCALE-from-EXPOSURE behavior (reference
    scripts/resample_all.sh:300-314); pass ref_exptime/exptime_i to
    stack mixed exposures in common flux units.

    Returns (stacked (H, W), diagnostics dict with per-frame transforms,
    inlier counts, rms, star counts).
    """
    with jax.named_scope("calibrate"):
        cal = calibrate_batch(
            frames, bias, dark, flat, exp_ratios,
            dark_still_biased=config.dark_still_biased,
            badpix_mask=badpix_mask)
        if flux_scales is not None:
            cal = cal * flux_scales.astype(jnp.float32)[:, None, None]

    stars, sims, matrices, ref_idx = register_frames(cal, config=config)

    stacked = stack_registered(cal, matrices, config=config)

    diagnostics = {
        "scale": sims.scale,
        "theta": sims.theta,
        "tx": sims.tx,
        "ty": sims.ty,
        "n_inliers": sims.n_inliers,
        "rms": sims.rms,
        "n_stars": jnp.sum(stars.valid, axis=1),
        "ref_frame": ref_idx,
        "matrices": matrices,
    }
    return stacked, diagnostics
