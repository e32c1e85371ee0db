"""dksraw CLI: grey | rgb | split (reference cli.py:46-311).

Common options (-l/--loglevel, -c/--config, -o/--output) and the
subcommand surfaces match the reference argparse tree:

* grey: --whitebalance {daylight,camera,auto,region[..],user[..]},
  --method {linear,direct}, --keepblack, --renormalize, --printstats
* rgb:  same minus direct method
* split: --keepblack, --extension (default tiff)
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .. import api
from ..utils.config import config
from ..utils.logger import logger
from ..__version__ import __version__

_WB_CHOICES = "daylight | camera | auto | region[rmin,rmax,cmin,cmax] | user[r,g,b,(g2)]"


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("rawfile", help="RAW file to convert (DNG/TIFF/PGM/FITS mosaic)")
    p.add_argument("-o", "--output", default=None,
                   help="output file (default: rawfile base + format extension)")
    p.add_argument("-l", "--loglevel", default="INFO",
                   choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
                   help="logging level")
    p.add_argument("-c", "--config", default=None,
                   help="YAML configuration file")


def _add_wb(p: argparse.ArgumentParser) -> None:
    p.add_argument("-w", "--whitebalance", default="daylight",
                   help=f"white balance method: {_WB_CHOICES}")
    p.add_argument("-b", "--keepblack", action="store_true",
                   help="do NOT subtract camera black levels")
    p.add_argument("-r", "--renormalize", action="store_true",
                   help="linearly stretch 0.01-99.99 percentiles to 16-bit range")
    p.add_argument("-s", "--printstats", action="store_true",
                   help="log image statistics")
    p.add_argument("-d", "--demosaic", default="mhc",
                   choices=["mhc", "bilinear", "ahd"],
                   help="demosaic algorithm (mhc = gradient-corrected "
                        "Malvar-He-Cutler, default; ahd = adaptive "
                        "homogeneity-directed, the LibRaw-parity option)")


def _args(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="dksraw",
        description="Device-native DSLR RAW converter (grey/rgb/split)")
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("grey", help="convert RAW to 16-bit greyscale")
    _add_common(g)
    _add_wb(g)
    g.add_argument("-m", "--method", default="linear",
                   choices=["linear", "direct"], help="luminance method")

    r = sub.add_parser("rgb", help="convert RAW to 16-bit RGB")
    _add_common(r)
    _add_wb(r)
    r.add_argument("-m", "--method", default="linear", choices=["linear"],
                   help="luminance method")

    s = sub.add_parser("split", help="split RAW into R/G1/B/G2 channel images")
    _add_common(s)
    s.add_argument("-b", "--keepblack", action="store_true",
                   help="do NOT subtract camera black levels")
    s.add_argument("-e", "--extension", default="tiff",
                   help="output graphics format extension (default tiff)")

    return parser.parse_args(argv)


def _default_output(rawfile: str, ext: str) -> str:
    base, _ = os.path.splitext(rawfile)
    return f"{base}.{ext}"


def main(argv: Optional[List[str]] = None) -> int:
    ns = _args(list(argv) if argv is not None else None)
    logger.start(ns.loglevel)
    if ns.config:
        config.load(ns.config)
        level = config.get("core", {}).get("logging", ns.loglevel) \
            if isinstance(config.get("core"), dict) else ns.loglevel
        logger.start(level)
    try:
        if ns.command == "grey":
            output = ns.output or _default_output(ns.rawfile, "png")
            api.grey(ns.rawfile, output, luminance_method=ns.method,
                     subtract_black=not ns.keepblack, wb_method=ns.whitebalance,
                     print_stats=ns.printstats, renormalize=ns.renormalize,
                     demosaic=ns.demosaic)
        elif ns.command == "rgb":
            output = ns.output or _default_output(ns.rawfile, "png")
            api.rgb(ns.rawfile, output, luminance_method=ns.method,
                    subtract_black=not ns.keepblack, wb_method=ns.whitebalance,
                    print_stats=ns.printstats, renormalize=ns.renormalize,
                    demosaic=ns.demosaic)
        elif ns.command == "split":
            output = ns.output or _default_output(ns.rawfile, ns.extension)
            api.split(ns.rawfile, output, subtract_black=not ns.keepblack,
                      extension=ns.extension)
    except Exception as exc:  # CLI boundary: log-and-exit-1 (reference cli.py:68-72)
        logger.error(f"{type(exc).__name__}: {exc}")
        return 1
    finally:
        logger.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
