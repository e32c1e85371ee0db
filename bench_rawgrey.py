#!/usr/bin/env python
"""Secondary benchmark: RAW -> greyscale FITS conversion, frames/sec.

No reference number exists — the reference runs LibRaw + numpy
single-threaded.  This measures end-to-end file-to-file
dksraw-grey throughput over a directory of DNGs, including host decode,
device black-sub/WB/demosaic/luma, and FITS encode, using the threaded
prefetch/writer pipeline (parallel/pipeline.py).

Prints ONE JSON line.  Env: BENCH_RAW_FRAMES,
BENCH_RAW_SIZE (square mosaic edge), BENCH_REPEATS,
BENCH_RAW_COMPRESSION (7 = camera-style lossless-JPEG strips, the
default — decode through the native T.81 codec dominates the host
side; 1 = uncompressed).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np


def write_synthetic_dngs(directory: str, n_frames: int, size: int,
                         compression: int = 7) -> list:
    """Write ``n_frames`` synthetic (size x size) DNGs into ``directory``
    and return their paths.

    One synthetic mosaic is written to n_frames distinct files (decode
    cost is content-independent; the loader has no cache).  Realistic
    sky statistics (background + read/photon noise), not 16-bit white
    noise: entropy-decode cost tracks real camera frames.
    """
    from astrophotography_tpu.io.raw import write_dng

    rng = np.random.default_rng(0)
    base = np.clip(rng.normal(900.0, 35.0, (size, size)),
                   0, 65535).astype(np.uint16)
    payload = None
    if compression == 7:
        # encode once, reuse the strip across files (decode cost is
        # per-file and value-independent)
        from astrophotography_tpu.io.losslessjpeg import encode_lossless_jpeg
        payload = encode_lossless_jpeg(base)
    paths = []
    for i in range(n_frames):
        p = os.path.join(directory, f"f{i:03d}.dng")
        write_dng(p, base, black_levels=(128, 128, 128, 128),
                  compression=compression, strip_payload=payload)
        paths.append(p)
    return paths


def run(n_frames: int, size: int, repeats: int,
        compression: int = 7) -> dict:
    """End-to-end RAW->grey FITS conversion benchmark; returns the
    result dict."""
    import jax

    from astrophotography_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from astrophotography_tpu.core.raw_conv import RawConv
    from astrophotography_tpu.io.fits import Header
    from astrophotography_tpu.parallel.pipeline import AsyncWriter

    tmp = tempfile.mkdtemp(prefix="bench_rawgrey_")
    paths = write_synthetic_dngs(tmp, n_frames, size, compression)

    import queue
    import threading

    def run_once() -> float:
        # three-stage overlap: decode thread -> device convert -> FITS
        # writer thread (host-side decode of frame i+1 hides behind the
        # device round trip of frame i)
        t0 = time.perf_counter()
        writer = AsyncWriter()
        decoded: "queue.Queue" = queue.Queue(maxsize=2)

        def decode_ahead():
            from astrophotography_tpu.io.raw import load_raw
            for p in paths:
                decoded.put((p, load_raw(p)))
            decoded.put(None)

        t = threading.Thread(target=decode_ahead, daemon=True)
        t.start()
        while True:
            item = decoded.get()
            if item is None:
                break
            p, raw = item
            conv = RawConv(p, raw_image=raw)
            # fetch=False: the u16 result stays on device; the writer
            # thread's np.asarray pulls it down while this loop uploads
            # and dispatches the NEXT frame (up and down transfers
            # overlap)
            img, _exif = conv.grey(wb_method="daylight", renorm=False,
                                   fetch=False)
            writer.submit(p[:-4] + ".fits", img, Header())
        t.join()
        writer.close()
        return time.perf_counter() - t0

    run_once()  # compile + warm
    # host-bound paths are noisy run to run: report the MEDIAN of
    # k >= 3 repeats with the spread so a single outlier never becomes
    # the figure
    k = max(repeats, 3)
    fps_runs = sorted(n_frames / run_once() for _ in range(k))
    fps = float(np.median(fps_runs))
    mpix = size * size / 1e6
    result = {
        "metric": f"RAW->grey FITS frames/s ({n_frames}x{mpix:.1f}Mpix "
                  f"{'lossless-JPEG ' if compression == 7 else ''}DNG,"
                  f" {jax.devices()[0].device_kind})",
        "value": fps,
        "unit": "frames/s",
        "method": f"median of {k} repeats",
        "spread": {"min": fps_runs[0], "max": fps_runs[-1]},
        "platform": jax.devices()[0].platform,
    }
    for p in paths:
        for q in (p, p[:-4] + ".fits"):
            try:
                os.remove(q)
            except OSError:
                pass
    return result


def main() -> int:
    result = run(
        n_frames=int(os.environ.get("BENCH_RAW_FRAMES", "24")),
        size=int(os.environ.get("BENCH_RAW_SIZE", "3904")),  # ~CR2-scale
        repeats=int(os.environ.get("BENCH_REPEATS", "3")),
        compression=int(os.environ.get("BENCH_RAW_COMPRESSION", "7")))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
