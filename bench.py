#!/usr/bin/env python
"""Benchmark: calibrate + register + sigma-clip stack throughput (GPix/s).

Runs the fused calibrate->detect->register->warp->stack pipeline
(``models.calibrate_register_stack``, the plain XLA path) over a
synthetic observing session: uint16 frames with bias, exposure-scaled
dark and flat masters (the full reference calibrate chain,
ApCalibrate.py:439-486) and SUB-PIXEL dithers, so the warp interpolates
real Lanczos weights.  The default session is 100 frames of 4096^2.

Prints one JSON line per cell, each naming the device it ran on:
the dither stack, the RAW->grey FITS conversion (bench_rawgrey.run),
and the same stack with 0.1-0.25 deg field rotations.  Any failure
exits non-zero; no cell falls back to a smaller size.

Env overrides: BENCH_FRAMES, BENCH_SIZE (square frame edge),
BENCH_REPEATS, BENCH_BANDS (force n_bands; default: the smallest
power of two whose compiled footprint fits the device);
BENCH_SKIP_RAWGREY=1 / BENCH_SKIP_ROTATION=1 skip those cells;
BENCH_RAW_FRAMES / BENCH_RAW_SIZE size the RAW cell.
"""

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

#: largest field rotation of the rotated session (deg)
ROTATION_MAX_DEG = 0.25


def make_workload(n_frames: int, size: int, rotate: bool = False):
    """Synthetic observing run with the full reference master set.

    Frames are uint16 raw counts: scene*flat + bias + 0.5*dark_counts
    (lights at half the dark master's exposure, so the exp-ratio dark
    scaling term is exercised with r != 1).  Dithers are SUB-PIXEL
    uniform(-4, 4); with ``rotate`` each frame additionally rotates
    about the field center by 0.1-0.25 deg — corner displacement
    ~5-13 px at 4k, beyond the separable warp's default shift budget
    (see :data:`ROTATION_MAX_DEG`).

    Returns (frames u16 (N,H,W), bias, dark_master, flat, exp_ratio,
    truth) where ``truth`` holds the injected motion: ``dx``, ``dy``,
    ``theta`` (N,) of each frame about the field center, the star
    positions ``xs``, ``ys`` on the reference frame, and
    ``max_offset_px``, the largest star displacement.
    """
    from astrophotography_tpu import synth

    rng = np.random.default_rng(0)
    # master planes: mild radial vignette flat, biased dark with hot px
    yy = (np.arange(size, dtype=np.float32) - size / 2) / size
    r2 = yy[:, None] ** 2 + yy[None, :] ** 2
    flat = (1.0 - 0.08 * r2 / r2.max()).astype(np.float32)
    bias = np.full((size, size), 300.0, np.float32)
    dark_counts = np.full((size, size), 40.0, np.float32)
    hot = rng.integers(0, size, (200, 2))
    dark_counts[hot[:, 0], hot[:, 1]] = 5000.0
    dark_master = bias + dark_counts  # dark_still_biased convention
    exp_ratio = 0.5  # 60 s lights vs 120 s master dark

    # star catalog (~40 stars, realistic levels)
    xs = rng.uniform(48, size - 48, 40)
    ys = rng.uniform(48, size - 48, 40)
    fl = rng.uniform(20000, 60000, 40)

    # fixed per-frame background: scene sky * flat + bias + r*dark.
    # Stars are painted per frame at their dithered (and rotated)
    # positions on small patches — a true sub-pixel-shifted scene at
    # host cost O(stars), not O(pixels)
    base_fixed = 800.0 * flat + bias + exp_ratio * dark_counts
    # independent sky noise per frame (sigma 8 ADU): each frame reads a
    # window of one shared bank at its own offset, so no pixel sees the
    # same sample twice across the stack
    spread = 1 << 20
    bank = 8.0 * rng.standard_normal(size * size + spread, dtype=np.float32)
    offsets = rng.choice(spread, n_frames, replace=False)
    cx = cy = (size - 1) / 2.0
    frames = np.empty((n_frames, size, size), np.uint16)
    motion = np.zeros((n_frames, 3))
    max_off = 0.0
    for i in range(n_frames):
        if i == 0:
            dx = dy = theta = 0.0
        else:
            dx, dy = rng.uniform(-4.0, 4.0, 2)  # sub-pixel, NOT rounded
            theta = (float(rng.choice([-1.0, 1.0])
                           * np.deg2rad(rng.uniform(0.1, 0.25)))
                     if rotate else 0.0)
        motion[i] = dx, dy, theta
        c, s = np.cos(theta), np.sin(theta)
        o = offsets[i]
        f = base_fixed + bank[o:o + size * size].reshape(size, size)
        for x, y, amp in zip(xs, ys, fl):
            # star center under this frame's similarity transform
            px = c * (x - cx) - s * (y - cy) + cx + dx
            py = s * (x - cx) + c * (y - cy) + cy + dy
            x0, y0 = int(px) - 12, int(py) - 12
            patch = synth.gaussian_star((25, 25), px - x0, py - y0,
                                        amp, 3.0)
            f[y0:y0 + 25, x0:x0 + 25] += patch * flat[y0:y0 + 25,
                                                      x0:x0 + 25]
            max_off = max(max_off, float(np.hypot(px - x, py - y)))
        frames[i] = np.clip(f, 0, 65535).astype(np.uint16)
    truth = {"dx": motion[:, 0], "dy": motion[:, 1], "theta": motion[:, 2],
             "xs": xs, "ys": ys, "max_offset_px": max_off}
    return frames, bias, dark_master, flat, exp_ratio, truth


def session_config(size: int, rotate: bool = False):
    """PipelineConfig of the benchmark session.

    The separable warp resamples exactly while |m10|*W <= warp_span - 6
    (ops/warp.warp_affine_separable); the rotated session derives its
    span from :data:`ROTATION_MAX_DEG` (with 2 px of margin for the
    registration's scale and rotation error) instead of silently
    dropping coverage past the default span's ~0.08 deg at 4k."""
    from astrophotography_tpu.models import PipelineConfig

    cfg = PipelineConfig(max_stars=48, match_k=10, interp="separable")
    if rotate:
        shear = math.sin(math.radians(ROTATION_MAX_DEG)) * size
        span = 2 * math.ceil((shear + 6 + 2) / 2)
        cfg = dataclasses.replace(cfg, warp_span=max(cfg.warp_span, span))
    return cfg


def bands_that_fit(args: dict, config):
    """(config, compiled bytes) with the smallest power-of-two n_bands
    whose compiled footprint (arguments + outputs + temporaries) fits
    the device's ``bytes_limit``; n_bands=1 where the device reports
    no limit.  ``args`` are calibrate_register_stack's array keywords."""
    import jax

    from astrophotography_tpu.models import calibrate_register_stack

    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    h = args["frames"].shape[1]
    n_bands = 1
    while True:
        cfg = dataclasses.replace(config, n_bands=n_bands)
        if limit is None:
            return cfg, None
        mem = calibrate_register_stack.lower(
            **args, config=cfg).compile().memory_analysis()
        need = (mem.argument_size_in_bytes + mem.output_size_in_bytes
                + mem.temp_size_in_bytes - mem.alias_size_in_bytes)
        if need <= limit or h % (2 * n_bands):
            return cfg, need
        n_bands *= 2


def session_args(n_frames: int, size: int, rotate: bool = False):
    """(host arrays as calibrate_register_stack keywords, truth) of
    :func:`make_workload`'s session."""
    frames, bias, dark, flat, exp_ratio, truth = make_workload(
        n_frames, size, rotate=rotate)
    args = {"frames": frames, "bias": bias, "dark": dark, "flat": flat,
            "exp_ratios": np.full((n_frames,), exp_ratio, np.float32)}
    return args, truth


def to_device(args: dict, device=None) -> dict:
    """The session's arrays committed to ``device`` (default: the
    default device)."""
    import jax

    return {k: jax.device_put(v, device) for k, v in args.items()}


def time_stack(args: dict, config, repeats: int = 2):
    """(first-run s, best warm s, stacked, diagnostics) of
    calibrate_register_stack, each run synced with block_until_ready."""
    import jax

    from astrophotography_tpu.models import calibrate_register_stack

    def run():
        t0 = time.perf_counter()
        out = calibrate_register_stack(**args, config=config)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, out

    cold, out = run()
    warm = min(run()[0] for _ in range(repeats))
    return cold, warm, out[0], out[1]


def stack_cell(n_frames: int, size: int, repeats: int,
               rotate: bool = False) -> dict:
    import jax

    host_args, truth = session_args(n_frames, size, rotate=rotate)
    args = to_device(host_args)
    del host_args
    forced = os.environ.get("BENCH_BANDS")
    cfg = session_config(size, rotate=rotate)
    if forced:
        cfg = dataclasses.replace(cfg, n_bands=int(forced))
    else:
        cfg, _need = bands_that_fit(args, cfg)
    _cold, warm, _stacked, _diag = time_stack(args, cfg, repeats)
    dev = jax.devices()[0]
    mode = "rotated 0.1-0.25deg" if rotate else "sub-px dithers"
    return {
        "metric": f"full-cal+register+stack GPix/s ({n_frames}x{size}^2, "
                  f"{mode})",
        "value": n_frames * size * size / warm / 1e9,
        "unit": "GPix/s",
        "single_run_ms": warm * 1000.0,
        "n_bands": cfg.n_bands,
        "warp_span": cfg.warp_span,
        "max_offset_px": truth["max_offset_px"],
        "peak_bytes_in_use": (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def main() -> int:
    from astrophotography_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    n_frames = int(os.environ.get("BENCH_FRAMES", "100"))
    size = int(os.environ.get("BENCH_SIZE", "4096"))
    print(json.dumps(stack_cell(n_frames, size, repeats)), flush=True)
    if os.environ.get("BENCH_SKIP_RAWGREY") != "1":
        import bench_rawgrey

        print(json.dumps(bench_rawgrey.run(
            n_frames=int(os.environ.get("BENCH_RAW_FRAMES", "6")),
            size=int(os.environ.get("BENCH_RAW_SIZE", "3904")),
            repeats=max(repeats, 3))), flush=True)
    if os.environ.get("BENCH_SKIP_ROTATION") != "1":
        print(json.dumps(stack_cell(n_frames, size, repeats, rotate=True)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
