#!/usr/bin/env python
"""Smoke test of the calibrate -> register -> stack system on one GPU.

Runs, in one process on the first GPU, the phases below, each through
the entry points a user calls, and checks every result:

* device   -- JAX must find a GPU; nothing runs on the CPU instead;
* session  -- 100 uint16 frames of 4096^2 with bias, dark and flat
  masters and sub-pixel dithers through ``calibrate_register_stack``:
  registration against the injected dithers, sky level and noise,
  finite and covered interior;
* rotation -- the same session with 0.1-0.25 deg field rotations, on
  the separable warp with a span derived from the rotation and on the
  direct Lanczos3 warp: registration and a constant-frame depth probe
  (every interior pixel stacks all N frames);
* parity   -- the same jitted code on the GPU and on the host CPU: the
  pipeline at 8 x 1024^2, the background spline zoom at 4008x2672, PSF
  fits of 64 stars and AHD demosaic + luma at 3904^2;
* cli      -- ``ap_reduce`` and ``ap_stack`` over 10 iTelescope-geometry
  (4008x2672) lights with masters on disk, and ``dksraw grey``/``rgb``
  over 2 lossless-JPEG DNGs, each called in this process and compared
  with the library call.

With ``--four`` it runs only the session jitted over a 4-GPU mesh
(frames sharded for calibrate/detect/warp, rows for the combine) and
compares it with the one-GPU result.  ``--trace DIR`` also writes a
``jax.profiler`` trace of one warm session run into DIR and prints its
device-time breakdown.

Usage, from the repository root:
    python chip_smoke.py [--four] [--trace DIR]

Prints the card's name and power limit, per-phase times and memory, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero without that line.
"""

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES, SIZE = 100, 4096
PARITY_FRAMES, PARITY_SIZE = 8, 1024
CLI_FRAMES, CLI_SHAPE = 10, (2672, 4008)  # iTelescope T20 bin 1
DNG_FRAMES, DNG_SIZE = 2, 3904
#: registration error at the stars, RMS over frames and stars (px)
REG_RMS_PX = 0.05
#: sky level the workload injects (ADU) and its per-frame noise
SKY_ADU, SKY_SIGMA = 800.0, 8.0
STAGES = ("calibrate", "noise_stats", "detect", "register", "warp",
          "combine")


class SmokeFailure(Exception):
    """A check of the smoke test failed."""


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The first device, which must be a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeFailure(f"JAX found no GPU (default backend {backend!r})")
    return jax.devices()[0]


def require_gpus(n: int):
    """The first ``n`` devices, which must all be GPUs."""
    import jax

    devices = jax.devices()
    check(len(devices) >= n and all(d.platform == "gpu" for d in devices[:n]),
          f"need {n} GPUs, JAX found {devices}")
    return devices[:n]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def memory(dev) -> str:
    stats = dev.memory_stats() or {}
    gb = {k: stats.get(k, 0) / 1e9 for k in ("peak_bytes_in_use",
                                             "bytes_limit")}
    return (f"peak_bytes_in_use {gb['peak_bytes_in_use']:.2f} GB of "
            f"bytes_limit {gb['bytes_limit']:.2f} GB")


# ----------------------------------------------------------------- checks


def registration_rms(matrices, truth) -> float:
    """RMS over frames and injected stars of |M_i p - T_i p| (px): the
    recovered output->input matrices M against the injected motion T
    (rotation by theta about the field center plus (dx, dy))."""
    m = np.asarray(matrices, np.float64)
    xs, ys = np.asarray(truth["xs"]), np.asarray(truth["ys"])
    size = truth["size"]
    c = (size - 1) / 2.0
    th = np.asarray(truth["theta"])[:, None]
    tx = (np.cos(th) * (xs - c) - np.sin(th) * (ys - c) + c
          + np.asarray(truth["dx"])[:, None])
    ty = (np.sin(th) * (xs - c) + np.cos(th) * (ys - c) + c
          + np.asarray(truth["dy"])[:, None])
    mx = m[:, 0, 0, None] * xs + m[:, 0, 1, None] * ys + m[:, 0, 2, None]
    my = m[:, 1, 0, None] * xs + m[:, 1, 1, None] * ys + m[:, 1, 2, None]
    return float(np.sqrt(np.mean((mx - tx) ** 2 + (my - ty) ** 2)))


def interior(truth, pad: int = 8) -> int:
    """Border width that every frame's warp covers, given the injected
    motion (largest star displacement + the 6-tap Lanczos footprint)."""
    return int(math.ceil(truth["max_offset_px"])) + pad


def sky_stats(stacked, truth, n_frames: int):
    """(median, robust std, bound) of the stacked sky on star-free
    interior pixels; ``bound`` is the largest robust std accepted: the
    per-frame noise averaged over N frames, with 25% for the flat
    division and uint16 quantisation."""
    img = np.asarray(stacked)
    t = interior(truth)
    free = np.zeros(img.shape, bool)
    free[t:-t, t:-t] = True
    for x, y in zip(truth["xs"], truth["ys"]):
        y0, x0 = int(y) - 16, int(x) - 16
        free[max(y0, 0):y0 + 33, max(x0, 0):x0 + 33] = False
    sky = img[free]
    med = float(np.median(sky))
    rstd = float(1.482602218505602 * np.median(np.abs(sky - med)))
    return med, rstd, 1.25 * SKY_SIGMA / math.sqrt(n_frames)


def check_stack(stacked, diag, truth, n_frames: int, what: str) -> str:
    """Registration, sky and coverage checks of one stacked session."""
    img = np.asarray(stacked)
    rms = registration_rms(diag["matrices"], truth)
    check(rms <= REG_RMS_PX,
          f"{what}: registration error {rms:.4f} px RMS > {REG_RMS_PX}")
    check(np.isfinite(img).all(), f"{what}: non-finite stacked pixels")
    t = interior(truth)
    inner = img[t:-t, t:-t]
    check((inner != 0).all(),
          f"{what}: {int((inner == 0).sum())} uncovered interior pixels")
    med, rstd, bound = sky_stats(img, truth, n_frames)
    check(abs(med - SKY_ADU) <= 1.0,
          f"{what}: sky median {med:.3f} ADU, expected {SKY_ADU} +- 1")
    check(rstd <= bound,
          f"{what}: sky robust std {rstd:.3f} ADU > {bound:.3f}")
    return (f"registration RMS {rms:.4f} px, sky median {med:.3f} ADU, "
            f"sky robust std {rstd:.3f} ADU (bound {bound:.3f})")


def depth_probe(matrices, shape, config):
    """Per-pixel sum of constant frames (frame i = 800 + i ADU) stacked
    with the session's registration; with every value positive, an
    interior pixel equals the full sum only if all N frames reach it."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from astrophotography_tpu.models import stack_registered

    n, h, w = shape

    @jax.jit
    def const_stack():
        vals = SKY_ADU + jnp.arange(n, dtype=jnp.float32)
        return jnp.broadcast_to(vals[:, None, None], (n, h, w))

    cfg = dataclasses.replace(config, combine="sum")
    return stack_registered(const_stack(), matrices, config=cfg)


def check_depth(summed, truth, n_frames: int, what: str) -> str:
    """Every interior pixel of :func:`depth_probe` holds all N frames:
    a missing frame lowers the sum by at least 800 ADU, so the interior
    must stay within half of that of the full sum."""
    full = n_frames * SKY_ADU + n_frames * (n_frames - 1) / 2.0
    t = interior(truth)
    inner = np.asarray(summed)[t:-t, t:-t]
    short = np.abs(inner - full) > SKY_ADU / 2
    check(not short.any(),
          f"{what}: {int(short.sum())} interior pixels "
          f"({100.0 * short.mean():.2f}%) stack fewer than {n_frames} frames")
    return f"depth {n_frames} at every interior pixel"


def relative_diff(got, ref):
    """(median, 99.9th percentile) of |got - ref| / max(|ref|, 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    return float(np.median(rel)), float(np.percentile(rel, 99.9))


# ----------------------------------------------------------------- phases


def phase_session(dev, n_frames, size, trace_dir=None):
    import bench

    host, truth = bench.session_args(n_frames, size)
    truth["size"] = size
    args = bench.to_device(host)
    del host
    t0 = time.perf_counter()
    cfg, need = bench.bands_that_fit(args, bench.session_config(size))
    t_compile = time.perf_counter() - t0
    cold, warm, stacked, diag = bench.time_stack(args, cfg)
    msg = check_stack(stacked, diag, truth, n_frames, "session")
    log(f"phase session: ok {n_frames}x{size}^2 n_bands {cfg.n_bands} "
        f"(compiled footprint {(need or 0) / 1e9:.2f} GB, compile "
        f"{t_compile:.1f} s), first run {cold:.3f} s, warm {warm:.4f} s, "
        f"{n_frames * size * size / warm / 1e9:.3f} GPix/s; {msg}; "
        f"{memory(dev)}")
    if trace_dir:
        trace_session(args, cfg, trace_dir)


def phase_rotation(dev, n_frames, size):
    import dataclasses

    import bench

    host, truth = bench.session_args(n_frames, size, rotate=True)
    truth["size"] = size
    args = bench.to_device(host)
    del host
    shape = args["frames"].shape
    derived = bench.session_config(size, rotate=True)
    configs = [("separable span %d" % derived.warp_span, derived),
               ("lanczos3", dataclasses.replace(derived, interp="lanczos3"))]
    for name, config in configs:
        t0 = time.perf_counter()
        cfg, _need = bench.bands_that_fit(args, config)
        t_compile = time.perf_counter() - t0
        cold, warm, stacked, diag = bench.time_stack(args, cfg)
        msg = check_stack(stacked, diag, truth, n_frames,
                          f"rotation {name}")
        matrices = diag["matrices"]
        del stacked, diag
        depth = check_depth(depth_probe(matrices, shape, cfg), truth,
                            n_frames, f"rotation {name}")
        log(f"phase rotation [{name}]: ok n_bands {cfg.n_bands}, compile "
            f"{t_compile:.1f} s, first run {cold:.3f} s, warm {warm:.4f} s; "
            f"{msg}; {depth}; "
            f"{memory(dev)}")
    # what the default span would have done (reported, not required)
    default = dataclasses.replace(derived, warp_span=12)
    summed = np.asarray(depth_probe(matrices, shape, default))
    full = n_frames * SKY_ADU + n_frames * (n_frames - 1) / 2.0
    t = interior(truth)
    short = np.abs(summed[t:-t, t:-t] - full) > SKY_ADU / 2
    log(f"phase rotation [default span 12]: {100.0 * short.mean():.2f}% "
        f"of interior pixels lose depth")


def phase_parity(dev):
    import jax

    import bench
    from astrophotography_tpu import synth
    from astrophotography_tpu.models import calibrate_register_stack
    from astrophotography_tpu.ops.background import background2d
    from astrophotography_tpu.ops.psf import measure_fwhm
    from astrophotography_tpu.ops.demosaic import raw_to_grey_linear, raw_to_rgb

    cpu = jax.devices("cpu")[0]

    def both(fn, *arrays):
        """fn on the GPU and on the CPU, inputs committed to each."""
        return [jax.tree_util.tree_map(
            np.asarray, fn(*(jax.device_put(a, d) for a in arrays)))
            for d in (dev, cpu)]

    # 1. the pipeline.  Transforms: 1e-3 px -- both sides solve the same
    # float32 least squares over the same matched stars, so only
    # rounding differs.  Stack: sums and sorts reassociate differently
    # on the two backends (median 1e-4 relative); a pixel whose value
    # sits on a sigma-clip bound may be kept on one side and clipped on
    # the other (99.9th percentile 1e-2 relative).
    host, _truth = bench.session_args(PARITY_FRAMES, PARITY_SIZE)
    cfg = bench.session_config(PARITY_SIZE)
    keys = list(host)
    (g_st, g_d), (c_st, c_d) = both(
        lambda *a: calibrate_register_stack(**dict(zip(keys, a)),
                                            config=cfg),
        *host.values())
    corners = np.array([[0, 0, 1], [PARITY_SIZE - 1, 0, 1],
                        [0, PARITY_SIZE - 1, 1],
                        [PARITY_SIZE - 1, PARITY_SIZE - 1, 1]], np.float64)
    dmap = np.abs(np.einsum("nij,kj->nki", g_d["matrices"] - c_d["matrices"],
                            corners)).max()
    check(dmap <= 1e-3, f"parity: transforms differ by {dmap:.2e} px")
    med, p999 = relative_diff(g_st, c_st)
    check(med <= 1e-4 and p999 <= 1e-2,
          f"parity: stack relative diff median {med:.2e}, 99.9% {p999:.2e}")
    log(f"phase parity [pipeline {PARITY_FRAMES}x{PARITY_SIZE}^2]: ok "
        f"transforms {dmap:.2e} px, stack median {med:.2e} / 99.9% "
        f"{p999:.2e} relative")

    # 2. background spline zoom at 4008x2672 (167 px boxes).  The zoom is
    # two f32 matmuls pinned to full precision: a TF32 product (~3
    # digits) would miss 1e-5 relative by two orders of magnitude.
    rng = np.random.default_rng(3)
    h, w = CLI_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sky = (1000.0 + 40.0 * np.sin(xx / 900.0) * np.cos(yy / 700.0)
           + rng.normal(0, 5.0, (h, w))).astype(np.float32)
    g_bg, c_bg = both(lambda d: background2d(d, nboxes_y=16, nboxes_x=24,
                                             upsample="spline"), sky)
    bg = float(np.max(np.abs(g_bg - c_bg)) / np.max(np.abs(c_bg)))
    check(bg <= 1e-5, f"parity: background zoom max relative diff {bg:.2e}")

    # 3. PSF fits of 64 stars: the LM normal equations in full f32
    # precision; positions to 1e-3 px, FWHM to 1e-3 relative (an LM
    # step accepted on one side only would move them by far more).
    img, cat = synth.make_starfield((1024, 1024), n_stars=64, fwhm=3.5,
                                    background=500.0, read_noise=5.0,
                                    flux_range=(20000.0, 60000.0), seed=4,
                                    min_sep=24.0)
    xs, ys = (np.asarray(cat[k], np.float32) for k in ("x", "y"))
    valid = np.ones(len(xs), bool)
    g_fit, c_fit = both(measure_fwhm, img.astype(np.float32), xs, ys, valid)
    ok = c_fit.valid & g_fit.valid
    check(ok.sum() >= 50, f"parity: only {int(ok.sum())} valid PSF fits")
    dpos = float(max(np.abs(g_fit.x0 - c_fit.x0)[ok].max(),
                     np.abs(g_fit.y0 - c_fit.y0)[ok].max()))
    dfw = float((np.abs(g_fit.fwhm_x - c_fit.fwhm_x)
                 / c_fit.fwhm_x)[ok].max())
    check(dpos <= 1e-3 and dfw <= 1e-3,
          f"parity: PSF fits differ by {dpos:.2e} px, FWHM {dfw:.2e}")

    # 4. AHD demosaic + luma at 3904^2.  AHD picks a direction per pixel
    # by comparing homogeneity counts, which rounding can flip where
    # two directions tie: median |diff| 1e-3 ADU, 99.9th percentile
    # 0.5 ADU.  A TF32 luma product would be off by tens of ADU.
    scene = synth.make_rgb_scene((DNG_SIZE, DNG_SIZE), seed=5, peak=40000)
    cmap = synth.bayer_color_map((DNG_SIZE, DNG_SIZE))
    mosaic = synth.mosaic_from_rgb(scene, black_levels=(128,) * 4,
                                   wb_gains=(2.0, 1.0, 1.5, 1.0))
    blacks = np.full(4, 128.0, np.float32)
    wb = np.array([2.0, 1.0, 1.5, 1.0], np.float32)
    g_rgb, c_rgb = both(lambda m, c: raw_to_rgb(m, c, blacks, wb,
                                                algorithm="ahd"), mosaic, cmap)
    g_y, c_y = both(lambda m, c: raw_to_grey_linear(m, c, blacks, wb,
                                                    algorithm="ahd"),
                    mosaic, cmap)
    for name, a, b in (("rgb", g_rgb, c_rgb), ("luma", g_y, c_y)):
        d = np.abs(a.astype(np.float64) - b)
        med, p999 = float(np.median(d)), float(np.percentile(d, 99.9))
        check(np.isfinite(a).all() and med <= 1e-3 and p999 <= 0.5,
              f"parity: AHD {name} |diff| median {med:.2e}, 99.9% {p999:.2e}")
    log(f"phase parity [ops]: ok background zoom {bg:.2e} relative, PSF "
        f"{int(ok.sum())} fits {dpos:.2e} px / FWHM {dfw:.2e}, AHD+luma "
        f"99.9% {p999:.2e} ADU")


def _write_itelescope_session(data, cal, n_frames, shape, rng):
    """Masters + ``n_frames`` dithered 300 s lights of one target and
    filter, named as iTelescope names its files."""
    from astrophotography_tpu import synth
    from astrophotography_tpu.io.fits import Header, write_image

    h, w = shape
    bias = rng.normal(300.0, 2.0, shape).astype(np.float32)
    dark_rate = np.abs(rng.normal(0.02, 0.005, shape)).astype(np.float32)
    flat = (1.0 - 0.06 * (((np.arange(w) - w / 2) / w) ** 2)[None, :]
            * np.ones((h, 1))).astype(np.float32)
    for name, typ, img, exp in (
            ("master_bias.fits", "MASTER BIAS", bias, None),
            ("master_dark.fits", "MASTER DARK", bias + dark_rate * 300.0, 300.0),
            ("master_flat_V.fits", "MASTER FLAT", flat, None)):
        hdr = Header()
        hdr["IMAGETYP"] = typ
        if exp:
            hdr["EXPTIME"] = exp
        if typ == "MASTER FLAT":
            hdr["FILTER"] = "V"
        write_image(os.path.join(cal, name), img.astype(np.float32), hdr)
    scene = np.full(shape, 120.0, np.float32)
    for _ in range(max(12, h * w // 180000)):
        x, y = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
        x0, y0 = int(x) - 12, int(y) - 12
        scene[y0:y0 + 25, x0:x0 + 25] += synth.gaussian_star(
            (25, 25), x - x0, y - y0, rng.uniform(20000, 60000), 3.0)
    for i in range(n_frames):
        dx, dy = (0, 0) if i == 0 else rng.integers(-4, 5, 2)
        sky = np.roll(np.roll(scene, dy, 0), dx, 1)
        img = (sky * flat + bias + dark_rate * 300.0
               + rng.normal(0, 4.0, shape)).astype(np.float32)
        hdr = Header()
        hdr["IMAGETYP"] = "Light Frame"
        hdr["OBJECT"] = "M42"
        hdr["TELESCOP"] = "T20"
        hdr["FILTER"] = "V"
        hdr["EXPTIME"] = 300.0
        hdr["DATE-OBS"] = f"2026-01-01T00:{i:02d}:00"
        write_image(os.path.join(data, f"M42-T20-V-{i:03d}.fits"), img, hdr)


def _library_stack(paths, ref_frame="auto"):
    """calibrate_register_stack over calibrated FITS files with the
    configuration ap_reduce and ap_stack build from their defaults."""
    import jax.numpy as jnp

    from astrophotography_tpu.io.fits import read_image
    from astrophotography_tpu.models import (PipelineConfig,
                                             calibrate_register_stack)

    frames, exps = [], []
    for p in paths:
        data, hdr = read_image(p)
        frames.append(data)
        exps.append(float(hdr.get("EXPTIME", 0.0) or 0.0))
    scales = np.asarray([exps[0] / e if e else 1.0 for e in exps], np.float32)
    cfg = PipelineConfig(fwhm=3.0, detect_nsigma=7.0, sigma_lower=5.0,
                         sigma_upper=5.0, combine="average",
                         ref_frame=ref_frame)
    stacked, _ = calibrate_register_stack(
        jnp.asarray(np.stack(frames)), flux_scales=jnp.asarray(scales),
        config=cfg)
    return np.asarray(stacked)


def phase_cli(dev, work):
    import bench_rawgrey
    from astrophotography_tpu.cli.ap_reduce import main as ap_reduce
    from astrophotography_tpu.cli.ap_stack import main as ap_stack
    from astrophotography_tpu.cli.dksraw import main as dksraw
    from astrophotography_tpu.core.raw_conv import RawConv
    from astrophotography_tpu.io.fits import open_fits, read_image

    rng = np.random.default_rng(11)
    data, cal, out = (os.path.join(work, d) for d in ("data", "cal", "out"))
    for d in (data, cal):
        os.makedirs(d)
    _write_itelescope_session(data, cal, CLI_FRAMES, CLI_SHAPE, rng)

    t0 = time.perf_counter()
    check(ap_reduce([data, cal, out, "-l", "ERROR"]) == 0,
          "cli: ap_reduce failed")
    t_reduce = time.perf_counter() - t0
    stack_path = os.path.join(out, "stack-M42-T20-V.fits")
    cals = sorted(os.path.join(out, f"cal-M42-T20-V-{i:03d}.fits")
                  for i in range(CLI_FRAMES))
    check(os.path.exists(stack_path) and all(map(os.path.exists, cals)),
          "cli: ap_reduce outputs missing")
    reduced, hdr = read_image(stack_path)
    check(hdr["NSTACK"] == CLI_FRAMES, "cli: ap_reduce NSTACK")
    lib = _library_stack(cals)
    d_reduce = float(np.max(np.abs(reduced - lib)))
    check(reduced.shape == CLI_SHAPE and np.isfinite(reduced).all()
          and d_reduce <= 1e-3,
          f"cli: ap_reduce stack differs from the library by {d_reduce}")

    t0 = time.perf_counter()
    stacked_path = os.path.join(work, "ap_stack.fits")
    check(ap_stack(cals + ["-o", stacked_path, "-l", "ERROR"]) == 0,
          "cli: ap_stack failed")
    t_stack = time.perf_counter() - t0
    stacked, _ = read_image(stacked_path)
    d_stack = float(np.max(np.abs(stacked - lib)))
    check(d_stack <= 1e-3,
          f"cli: ap_stack differs from the library by {d_stack}")

    raws = bench_rawgrey.write_synthetic_dngs(work, DNG_FRAMES, DNG_SIZE)
    t0 = time.perf_counter()
    for raw in raws:
        grey_path, rgb_path = raw[:-4] + "_grey.fits", raw[:-4] + "_rgb.fits"
        check(dksraw(["grey", raw, "-o", grey_path, "-l", "ERROR"]) == 0,
              "cli: dksraw grey failed")
        check(dksraw(["rgb", raw, "-o", rgb_path, "-l", "ERROR"]) == 0,
              "cli: dksraw rgb failed")
        conv = RawConv(raw)
        grey, _ = conv.grey(wb_method="daylight")
        rgb, _ = conv.rgb(wb_method="daylight")
        got = open_fits(grey_path)[0].data
        check(got.shape == (DNG_SIZE, DNG_SIZE)
              and np.array_equal(got, grey), "cli: dksraw grey mismatch")
        planes = {h.header.get("FILTER"): h.data for h in open_fits(rgb_path)
                  if h.data is not None}
        check(all(np.array_equal(planes.get(c), rgb[..., i])
                  for i, c in enumerate("RGB")), "cli: dksraw rgb mismatch")
    t_raw = time.perf_counter() - t0
    log(f"phase cli: ok ap_reduce {CLI_FRAMES}x{CLI_SHAPE[1]}x{CLI_SHAPE[0]} "
        f"{t_reduce:.2f} s (stack vs library {d_reduce:.2e}), ap_stack "
        f"{t_stack:.2f} s ({d_stack:.2e}), dksraw grey+rgb "
        f"{DNG_FRAMES}x{DNG_SIZE}^2 {t_raw:.2f} s; {memory(dev)}")


def phase_four(n_frames, size):
    """The session over a 4-GPU mesh against the one-GPU result."""
    import jax

    import bench
    from astrophotography_tpu.models import calibrate_register_stack
    from astrophotography_tpu.parallel.mesh import (
        frame_space_mesh, replicate, shard_frames,
        sharded_calibrate_register_stack)

    devices = require_gpus(4)
    host, truth = bench.session_args(n_frames, size)
    truth["size"] = size
    one = bench.to_device(host, devices[0])
    cfg, _need = bench.bands_that_fit(one, bench.session_config(size))
    cold1, warm1, st1, d1 = bench.time_stack(one, cfg)
    msg = check_stack(st1, d1, truth, n_frames, "one GPU")
    st1, m1 = np.asarray(st1), np.asarray(d1["matrices"])
    del one, d1
    gc.collect()

    mesh = frame_space_mesh(devices=devices)
    step = sharded_calibrate_register_stack(mesh, cfg)
    arrays = [jax.device_put(host["frames"], shard_frames(mesh))] + [
        jax.device_put(host[k], replicate(mesh))
        for k in ("bias", "dark", "flat", "exp_ratios")]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st4, d4 = jax.block_until_ready(step(*arrays))
        times.append(time.perf_counter() - t0)
    check(len(st4.sharding.device_set) == 4,
          "four: the stacked output is not sharded over 4 GPUs")
    msg4 = check_stack(st4, d4, truth, n_frames, "four GPUs")
    dmat = float(np.abs(np.asarray(d4["matrices"]) - m1).max())
    med, p999 = relative_diff(st4, st1)
    check(dmat <= 1e-3 and med <= 1e-4 and p999 <= 1e-2,
          f"four: vs one GPU matrices {dmat:.2e}, stack median {med:.2e}, "
          f"99.9% {p999:.2e}")
    log(f"phase four: ok {n_frames}x{size}^2 one GPU cold {cold1:.3f} s "
        f"warm {warm1:.4f} s ({msg}); four GPUs cold {times[0]:.3f} s "
        f"warm {min(times[1:]):.4f} s ({msg4}); vs one GPU: matrices "
        f"{dmat:.2e}, stack median {med:.2e} / 99.9% {p999:.2e} relative; "
        + "; ".join(memory(d) for d in devices))


# ------------------------------------------------------------------ trace


def trace_session(args, config, trace_dir):
    """One warm session run under jax.profiler; prints device time by
    pipeline stage and the top device operations, and writes the op
    table to DIR/ops.json."""
    import glob

    import jax

    from astrophotography_tpu.models import calibrate_register_stack

    hlo = calibrate_register_stack.lower(
        **args, config=config).compile().as_text()
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(calibrate_register_stack(**args, config=config))
        wall = time.perf_counter() - t0
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    stages, ops, busy = device_breakdown(path, op_stages(hlo))
    total = sum(stages.values()) or 1.0
    log(f"trace: wall {wall:.4f} s, device busy {busy / 1e9:.4f} s "
        f"({100.0 * busy / 1e9 / wall:.1f}% of wall), {path}")
    for name, ns in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"trace stage {name}: {ns / 1e6:.3f} ms "
            f"({100.0 * ns / total:.1f}%)")
    table = sorted(ops.items(), key=lambda kv: -kv[1])
    for (name, stage), ns in table[:20]:
        log(f"trace op {name[:60]} [{stage}]: {ns / 1e6:.3f} ms "
            f"({100.0 * ns / total:.1f}%)")
    with open(os.path.join(trace_dir, "ops.json"), "w") as fh:
        json.dump({"wall_s": wall, "busy_ns": busy, "stages_ns": stages,
                   "ops_ns": [[n, st, ns] for (n, st), ns in table]}, fh,
                  indent=1)


def op_stages(hlo_text: str) -> dict:
    """{kernel name: stage} of the instructions of an optimized HLO
    module, from the named scopes in their op_name metadata (a GPU
    kernel is named after its instruction, '.' and '-' read as '_')."""
    import re

    pat = re.compile(r'%?([\w.\-]+) = .*metadata=\{[^}]*op_name="([^"]*)"')
    out = {}
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if m:
            parts = m.group(2).split("/")
            out[re.sub(r"[.\-]", "_", m.group(1))] = next(
                (st for st in STAGES if st in parts), "other")
    return out


def device_breakdown(path, stage_of: dict):
    """({stage: ns}, {(op, stage): ns}, busy ns) of the GPU planes of
    an .xplane.pb trace.  An op's stage comes from ``stage_of`` by its
    HLO instruction name (the event's ``hlo_op``, or its kernel name
    inside a command buffer), trailing '_<n>' kernel suffixes stripped
    until a name is found; else 'other'."""
    import re

    import jax

    data = jax.profiler.ProfileData.from_file(path)
    stages, ops, intervals = {}, {}, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                hlo_op = dict(ev.stats).get("hlo_op", "")
                name = (ev.name if hlo_op in ("", "command_buffer")
                        else re.sub(r"[.\-]", "_", hlo_op))
                key = name
                while key not in stage_of and re.search(r"_\d+$", key):
                    key = re.sub(r"_\d+$", "", key)
                stage = stage_of.get(key, "other")
                stages[stage] = stages.get(stage, 0) + ev.duration_ns
                ops[(name, stage)] = ops.get((name, stage), 0) \
                    + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return stages, ops, busy


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the session over a 4-GPU mesh and "
                        "compare it with one GPU")
    p.add_argument("--trace", metavar="DIR",
                   help="also trace one warm session run into DIR")
    ns = p.parse_args(argv)
    try:
        dev = require_gpu()
        import jax

        from astrophotography_tpu.utils.compile_cache import (
            enable_compile_cache)

        log(f"card: {card_line()}")
        log(f"jax {jax.__version__}, {dev.platform} {dev.device_kind} x "
            f"{len(jax.devices())}, compile cache {enable_compile_cache()}, "
            f"{memory(dev)}")
        phases = ([("four", lambda: phase_four(N_FRAMES, SIZE))] if ns.four
                  else [("session", lambda: phase_session(
                      dev, N_FRAMES, SIZE, ns.trace)),
                        ("rotation", lambda: phase_rotation(
                            dev, N_FRAMES, SIZE)),
                        ("parity", lambda: phase_parity(dev)),
                        ("cli", None)])
        for name, run in phases:
            t0 = time.perf_counter()
            if run is None:
                with tempfile.TemporaryDirectory() as work:
                    phase_cli(dev, work)
            else:
                run()
            gc.collect()
            log(f"phase {name} wall {time.perf_counter() - t0:.1f} s")
    except Exception as exc:
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
