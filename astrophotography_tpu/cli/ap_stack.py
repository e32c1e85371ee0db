"""ap_stack: register and sigma-clip stack calibrated FITS frames.

The standalone form of the reference's swarp resample + combine step
(scripts/resample_all.sh:62-79 COMBINE_TYPE / FSCALE handling) over the
device pipeline: star detection, similarity registration, Lanczos3
warp, and sigma-clipped combine run as one jitted computation — no
astrometric solve required.  Mixed exposures are scaled into the
reference frame's flux units via EXPTIME (swarp
FSCALE-from-EXPOSURE, resample_all.sh:300-314).
"""

from __future__ import annotations

import argparse
import functools
import os
import time
from typing import List, Optional

import numpy as np

from .common import add_loglevel, cli_main
from ..io.fits import Header, read_image, write_image
from ..ops.register import REJECTED_TRANSLATION
from ..utils.logger import get_logger

logger = get_logger("cli.ap_stack")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_stack",
        description="Register + sigma-clip stack calibrated FITS frames")
    p.add_argument("inputs", nargs="+", help="input calibrated FITS frames")
    p.add_argument("-o", "--output", required=True,
                   help="output stacked FITS image")
    p.add_argument("--combine", default="average",
                   choices=("average", "median", "sum"),
                   help="combine method (swarp COMBINE_TYPE; default average)")
    p.add_argument("--sigma", type=float, default=5.0,
                   help="sigma clip bound (default 5)")
    p.add_argument("--ref_frame", default="auto",
                   help="registration reference: frame index or 'auto' "
                        "(frame with the most detected stars)")
    p.add_argument("--search_fwhm", type=float, default=3.0)
    p.add_argument("--search_nsigma", type=float, default=7.0)
    p.add_argument("--no-fscale", action="store_true",
                   help="do not scale mixed exposures by EXPTIME")
    p.add_argument("--canvas", default="first", choices=("first", "union"),
                   help="output grid: 'first' = the reference frame's "
                        "pixel grid; 'union' = a canvas covering every "
                        "registered frame (the swarp mosaic behavior)")
    p.add_argument("--weight_out", default=None, metavar="PATH",
                   help="also write the swarp-style coadd weight map "
                        "(sum over contributing frames of their "
                        "resample-footprint coverage, scaled by "
                        "1/fscale^2 when FSCALE applies — the WEIGHTOUT "
                        "image of reference resample_all.sh:342)")
    add_loglevel(p)
    return p.parse_args(argv)


def _stack_union_canvas(stack, scales, cfg):
    """Mosaic-style stacking: output grid = union of every registered
    frame (reference swarp's common output grid, resample_all.sh).

    Static-shape handling: the data-dependent canvas geometry is
    resolved on the HOST between two static-shape device passes —
    (1) jitted detection+registration, (2) host corner math on the
    (N, 2, 3) matrices, (3) jitted warp+combine at the static padded
    canvas shape (dynamic shapes never reach XLA)."""
    import jax
    import jax.numpy as jnp

    from ..models.pipeline import register_frames
    from ..ops.stack import sigma_clip_combine
    from ..ops.warp import warp_affine_separable

    n, h, w = stack.shape
    cal = jnp.asarray(stack)
    if scales is not None:
        cal = cal * scales[:, None, None]
    stars, sims, matrices, ref_idx = register_frames(cal, config=cfg)
    mats = np.asarray(matrices)          # (n, 2, 3): ref -> frame coords
    inl = np.asarray(sims.n_inliers)

    # host canvas math: map each registered frame's corners INTO the
    # reference grid (inverse transform) and take the union box
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float64)
    lo = np.array([0.0, 0.0])
    hi = np.array([float(w - 1), float(h - 1)])
    for i in range(n):
        if inl[i] < 4 and i != int(ref_idx):
            continue   # unregistered frames are excluded anyway
        if i != int(ref_idx) and (np.abs(mats[i, :, 2]).max()
                                  > REJECTED_TRANSLATION / 2):
            # registration degeneracy gate (ops/register.py) replaces a
            # rejected solve's translation with the REJECTED_TRANSLATION
            # sentinel even when n_inliers >= 4; folding that into the
            # union box would demand a ~2e9-px canvas.
            logger.warning(f"frame {i}: rejected registration (sentinel "
                           "translation); excluded from the union canvas")
            continue
        A = mats[i, :, :2]
        t = mats[i, :, 2]
        inv = np.linalg.inv(A)
        pts = (corners - t[None, :]) @ inv.T
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    x0 = int(np.floor(lo[0])) - 4
    y0 = int(np.floor(lo[1])) - 4
    wc = int(np.ceil(hi[0])) + 5 - x0
    hc = int(np.ceil(hi[1])) + 5 - y0
    wc = -(-wc // 16) * 16   # static-friendly canvas quantum
    hc = -(-hc // 16) * 16
    # canvas pixel (xc, yc) = reference pixel (xc + x0, yc + y0):
    # fold the origin shift into each matrix
    shift = np.stack([mats[:, 0, 0] * x0 + mats[:, 0, 1] * y0,
                      mats[:, 1, 0] * x0 + mats[:, 1, 1] * y0], axis=1)
    mats_c = mats.copy()
    mats_c[:, :, 2] += shift

    @functools.partial(jax.jit, static_argnames=("hc", "wc", "combine"))
    def warp_combine(cal, mats_c, hc, wc, combine):
        warped, covers = jax.vmap(
            lambda f, m: warp_affine_separable(
                f, m, (hc, wc), span=cfg.warp_span,
                analytic_coverage=True))(cal, mats_c)
        out = sigma_clip_combine(warped, mask=covers > 0.5,
                                 sigma_lower=cfg.sigma_lower,
                                 sigma_upper=cfg.sigma_upper,
                                 method=combine)
        return jnp.where(jnp.isnan(out), 0.0, out)

    stacked = warp_combine(cal, jnp.asarray(mats_c, jnp.float32),
                           hc, wc, cfg.combine)
    diag = {"scale": sims.scale, "theta": sims.theta, "tx": sims.tx,
            "ty": sims.ty, "n_inliers": sims.n_inliers, "rms": sims.rms,
            "n_stars": jnp.sum(stars.valid, axis=1),
            "ref_frame": ref_idx,
            "canvas_origin": (y0, x0),
            "matrices": mats_c}
    logger.info(f"Union canvas {hc}x{wc} px, origin ({y0}, {x0}) in the "
                f"reference frame's grid")
    return stacked, diag


def _coverage_weight_map(mats, in_shape, out_shape, scales, usable=None):
    """swarp WEIGHTOUT map via ops.warp.coverage_weight_map with
    per-frame weights 1 (no FSCALE) or 1/fscale^2; ``usable`` zeroes
    frames that failed registration so the map reflects usable depth."""
    import jax.numpy as jnp

    from ..ops.warp import coverage_weight_map

    n = mats.shape[0]
    if scales is None:
        fw = np.ones((n,), np.float32)
    else:
        fw = 1.0 / np.square(np.asarray(scales, np.float32))
    if usable is not None:
        fw = fw * np.asarray(usable, np.float32)
    return np.asarray(coverage_weight_map(
        jnp.asarray(mats, jnp.float32), tuple(int(v) for v in in_shape),
        tuple(int(v) for v in out_shape), jnp.asarray(fw, jnp.float32)))


def run(ns: argparse.Namespace) -> None:
    import jax.numpy as jnp

    from ..models.pipeline import PipelineConfig, calibrate_register_stack

    if len(ns.inputs) < 2:
        raise ValueError("ap_stack needs at least 2 input frames")
    frames = []
    exps = []
    hdrs = []
    for path in ns.inputs:
        data, hdr = read_image(path)
        if frames and data.shape != frames[0].shape:
            raise ValueError(
                f"{path!r} shape {data.shape} differs from first frame "
                f"{frames[0].shape}")
        frames.append(data)
        exps.append(float(hdr.get("EXPTIME", 0.0) or 0.0))
        hdrs.append(hdr)
    stack = np.stack(frames)
    if ns.no_fscale or not exps[0]:
        scales = None
    else:
        scales = jnp.asarray([exps[0] / e if e else 1.0 for e in exps],
                             jnp.float32)

    ref_frame = (int(ns.ref_frame)
                 if str(ns.ref_frame).lstrip("-").isdigit()
                 else ns.ref_frame)
    cfg = PipelineConfig(
        fwhm=ns.search_fwhm, detect_nsigma=ns.search_nsigma,
        sigma_lower=ns.sigma, sigma_upper=ns.sigma,
        combine=ns.combine, ref_frame=ref_frame)
    t0 = time.perf_counter()
    if ns.canvas == "union":
        stacked, diag = _stack_union_canvas(stack, scales, cfg)
    else:
        stacked, diag = calibrate_register_stack(
            jnp.asarray(stack), flux_scales=scales, config=cfg)
    stacked = np.asarray(stacked)
    dt = time.perf_counter() - t0

    inl = np.asarray(diag["n_inliers"])
    ref_idx = int(diag["ref_frame"])
    bad = [os.path.basename(ns.inputs[i]) for i in range(len(inl))
           if inl[i] < 4 and i != ref_idx]
    if bad:
        logger.warning(f"{len(bad)} frame(s) registered with < 4 inliers "
                       f"and contribute little or nothing: {bad}")

    # the output grid is the REFERENCE frame's pixel grid (shifted by
    # the canvas origin in union mode), so inherit ITS header — an
    # inherited WCS then describes the output correctly
    out_hdr = hdrs[ref_idx].copy() if hdrs else Header()
    out_hdr["IMAGETYP"] = ("STACK", "Registered stacked image")
    out_hdr["NSTACK"] = (len(frames), "Number of frames in stack")
    if "canvas_origin" in diag:
        cy0, cx0 = diag["canvas_origin"]
        out_hdr["CANVASY0"] = (int(cy0), "Canvas row 0 in reference"
                                        " frame coords")
        out_hdr["CANVASX0"] = (int(cx0), "Canvas col 0 in reference"
                                        " frame coords")
        # keep an inherited WCS valid on the shifted grid:
        # x_canvas = x_ref - x0  =>  CRPIX += -origin
        if "CRPIX1" in out_hdr and "CRPIX2" in out_hdr:
            out_hdr["CRPIX1"] = float(out_hdr["CRPIX1"]) - float(cx0)
            out_hdr["CRPIX2"] = float(out_hdr["CRPIX2"]) - float(cy0)
            out_hdr.add_history(
                f"CRPIX shifted by ({-cx0}, {-cy0}) for the union canvas")
    if exps[0]:
        out_hdr["EXPTOTAL"] = (float(np.sum(exps)),
                               "[s] Total stacked exposure")
    for i, path in enumerate(ns.inputs):
        out_hdr[f"ISTK{i:04d}"] = os.path.basename(path)
    out_hdr.add_history(
        f"ap_stack: {len(frames)} frames, combine={ns.combine}, "
        f"sigma={ns.sigma}, ref={ref_idx}")
    write_image(ns.output, stacked, out_hdr)
    if ns.weight_out:
        # frames with < 4 inliers (except the reference) registered
        # unreliably and contribute little or nothing to the combine —
        # zero their weight so the map reflects usable depth, matching
        # the union-canvas path's rejection behavior
        usable = inl >= 4
        usable[ref_idx] = True
        wmap = _coverage_weight_map(np.asarray(diag["matrices"]),
                                    stack.shape[1:], stacked.shape, scales,
                                    usable=usable)
        whdr = out_hdr.copy()
        whdr["IMAGETYP"] = ("STACK WEIGHT", "Coadd weight map")
        whdr.add_history(
            f"ap_stack weight map for {os.path.basename(ns.output)} "
            "(sum of frame coverage x 1/fscale^2)")
        write_image(ns.weight_out, wmap, whdr)
        logger.info(f"Wrote weight map {ns.weight_out} "
                    f"(max {wmap.max():.3f})")
    rms = np.asarray(diag["rms"])
    others = np.delete(rms, ref_idx) if len(rms) > 1 else rms
    logger.info(f"Stacked {len(frames)} frames -> {ns.output} "
                f"(ref frame {ref_idx}, reg rms median "
                f"{np.median(others):.3f} px, {dt:.2f} s)")


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
