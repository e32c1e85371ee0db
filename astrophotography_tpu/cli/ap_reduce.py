"""ap_reduce: batch reduction driver (calibrate_all/navigate_all/
resample_all replacement in one tool).

Covers the reference's bash L5 layer: per-target/filter calibration,
quality reporting, and device-side register+stack, with noclean
idempotency (reference calibrate_all.sh arguments
[target] [telescope] [skybg|noskybg] [noclean|clean]).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_loglevel, cli_main
from ..core.reduce import ReduceConfig, reduce_all


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_reduce",
        description="Batch-reduce a directory of light frames: calibrate, "
                    "quality, register+stack per target/telescope/filter")
    p.add_argument("datadir", help="directory of raw light FITS frames")
    p.add_argument("caldir", help="calibration library directory (masters)")
    p.add_argument("outdir", help="output directory")
    p.add_argument("--skybg", action="store_true",
                   help="subtract the modelled sky background")
    p.add_argument("--fixcosmic", action="store_true",
                   help="apply cosmic ray removal during calibration")
    p.add_argument("--clean", action="store_true",
                   help="recompute outputs even if they exist "
                        "(default: noclean/skip-existing)")
    p.add_argument("--no-quality", action="store_true",
                   help="skip star finding / quality reports")
    p.add_argument("--no-weights", action="store_true",
                   help="do not write the swarp-style weight-*.fits coadd "
                        "weight map next to each stack")
    p.add_argument("--no-stack", action="store_true",
                   help="skip registration + stacking")
    p.add_argument("--astrometry", action="store_true",
                   help="run the per-image WCS stage (navigate_all "
                        "parity): write nav-*.fits WCS-stamped images, "
                        "add ra/dec to source lists, and stamp the "
                        "stack with the reference frame's WCS. Without "
                        "--key this is network-free: the first "
                        "WCS-bearing frame of each group anchors "
                        "registration-based solves for the rest")
    p.add_argument("--key", default=None,
                   help="astrometry.net API key: plate-solve every "
                        "image through nova.astrometry.net (implies "
                        "--astrometry)")
    p.add_argument("--use-sip", dest="use_sip", action="store_true",
                   help="request a SIP order-2 distortion from nova "
                        "solves (with --key)")
    p.add_argument("--astrometry_timeout", type=float, default=180.0,
                   help="per-image solve timeout in seconds "
                        "(default 180)")
    p.add_argument("--search_fwhm", type=float, default=3.0)
    p.add_argument("--search_nsigma", type=float, default=7.0)
    p.add_argument("--stack_sigma", type=float, default=5.0)
    p.add_argument("--ref_frame", default="auto",
                   help="registration reference: frame index or 'auto' "
                        "(frame with the most detected stars)")
    p.add_argument("--stack_combine", default="average",
                   choices=["average", "median", "sum"])
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the reduction "
                        "into DIR (view with TensorBoard / xprof)")
    p.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                   help="run continuously: rescan the data directory every "
                        "SECONDS and reduce new frames (noclean skips "
                        "completed work)")
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    transport = None
    if ns.key:
        from ..wcs.astrometry import nova_transport

        transport = nova_transport(ns.key, use_sip=ns.use_sip)
    elif ns.use_sip:
        from ..utils.logger import logger as _log

        _log.warning("--use-sip has no effect without --key: the "
                     "network-free registration solve inherits SIP from "
                     "the anchor frame's own WCS")
    cfg = ReduceConfig(
        fixcosmic=ns.fixcosmic,
        skybg=ns.skybg,
        search_fwhm=ns.search_fwhm,
        search_nsigma=ns.search_nsigma,
        stack_sigma=ns.stack_sigma,
        stack_combine=ns.stack_combine,
        ref_frame=(int(ns.ref_frame) if str(ns.ref_frame).lstrip("-").isdigit()
                   else ns.ref_frame),
        noclean=not ns.clean,
        quality=not ns.no_quality,
        stack=not ns.no_stack,
        stack_weights=not ns.no_weights,
        astrometry=ns.astrometry or bool(ns.key),
        astrometry_transport=transport,
        astrometry_timeout=ns.astrometry_timeout)
    if ns.watch is None:
        if ns.profile:
            # structured tracing (SURVEY.md §5 "tracing/profiling": the
            # reference only has ad-hoc perf_counter logs; the profiler
            # captures per-op device timelines)
            import jax

            with jax.profiler.trace(ns.profile):
                reduce_all(ns.datadir, ns.caldir, ns.outdir, cfg)
        else:
            reduce_all(ns.datadir, ns.caldir, ns.outdir, cfg)
        return
    # continuous mode: incoming frames are reduced as they appear; the
    # skip-existing idempotency makes each sweep incremental
    import time as _time

    from ..utils.logger import logger as _log

    while True:
        try:
            reduce_all(ns.datadir, ns.caldir, ns.outdir, cfg)
        except RuntimeError as exc:
            _log.warning(f"watch sweep: {exc}")
        _time.sleep(ns.watch)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
