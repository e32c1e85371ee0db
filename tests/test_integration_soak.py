"""End-to-end integration soak: ap_reduce over a multi-filter dataset
with masters, cosmic rays, sky background, quality reports, the
register+stack pipeline, and idempotent re-runs — the full calibrate_all.sh /
navigate_all.sh / resample_all.sh chain in one driver invocation."""

import glob
import os

import numpy as np
import pytest

# multi-stage soak runs: full-suite tier
pytestmark = pytest.mark.slow

from astrophotography_tpu import synth
from astrophotography_tpu.io.fits import Header, read_image, write_image
from astrophotography_tpu.cli.ap_reduce import main as ap_reduce


def test_ap_reduce_multi_filter_soak(tmp_path):
    rng = np.random.default_rng(99)
    data = str(tmp_path / "data")
    cal = str(tmp_path / "cal")
    out = str(tmp_path / "out")
    os.makedirs(data)
    os.makedirs(cal)

    shape = (128, 128)
    bias = rng.normal(300.0, 2.0, shape).astype(np.float32)
    dark_rate = np.abs(rng.normal(0.5, 0.1, shape)).astype(np.float32)
    flat = ((1.0 + 0.08 * np.sin(np.arange(shape[1]) / 9.0))[None, :]
            * np.ones(shape)).astype(np.float32)

    h = Header()
    h["IMAGETYP"] = "MASTER BIAS"
    write_image(os.path.join(cal, "master_bias.fits"), bias, h)
    h = Header()
    h["IMAGETYP"] = "MASTER DARK"
    h["EXPTIME"] = 60.0
    write_image(os.path.join(cal, "master_dark.fits"),
                (bias + dark_rate * 60.0).astype(np.float32), h)
    for f in ("V", "R"):
        h = Header()
        h["IMAGETYP"] = "MASTER FLAT"
        h["FILTER"] = f
        write_image(os.path.join(cal, f"master_flat_{f}.fits"),
                    flat * 2.0, h)

    scene, _ = synth.make_starfield(shape, n_stars=6, fwhm=3.0,
                                    background=80.0, read_noise=0.0,
                                    flux_range=(20000.0, 50000.0),
                                    seed=7, min_sep=16.0)
    for filt in ("V", "R"):
        for i in range(4):
            dx, dy = (0, 0) if i == 0 else rng.integers(-3, 4, 2)
            sky = np.roll(np.roll(scene, dy, 0), dx, 1)
            img = (sky * flat + bias + dark_rate * 120.0
                   + rng.normal(0, 3, shape))
            img[rng.integers(20, 108), rng.integers(20, 108)] += 30000.0
            h = Header()
            h["IMAGETYP"] = "Light Frame"
            h["OBJECT"] = "M42"
            h["TELESCOP"] = "T05"
            h["FILTER"] = filt
            h["EXPTIME"] = 120.0
            h["DATE-OBS"] = f"2026-01-0{i + 1}T00:00:00"
            write_image(os.path.join(data, f"M42-T05-{filt}-{i:03d}.fits"),
                        img.astype(np.float32), h)

    rc = ap_reduce([data, cal, out, "--fixcosmic", "--skybg",
                    "-l", "ERROR"])
    assert rc == 0
    stacks = sorted(glob.glob(os.path.join(out, "stack-*.fits")))
    cals = sorted(glob.glob(os.path.join(out, "cal-*.fits")))
    quals = sorted(glob.glob(os.path.join(out, "*qual*")))
    assert len(stacks) == 2 and len(cals) == 8 and len(quals) == 8
    for sp in stacks:
        s, hdr = read_image(sp)
        assert hdr["IMAGETYP"] == "STACK"
        assert hdr["NSTACK"] == 4
        assert hdr["EXPTOTAL"] == 480.0
        assert np.isfinite(s).all()
        inner = s[25:-25, 25:-25]
        # robust sky scatter ~ Poisson(80)/sqrt(4); stars excluded by
        # the percentile clip, CRs removed by fixcosmic + sigma clip
        lo, hi = np.percentile(inner, [5, 85])
        skypix = inner[(inner >= lo) & (inner <= hi)]
        assert np.std(skypix) < 8.0, (sp, float(np.std(skypix)))
        # stars survived every stage
        assert inner.max() > np.median(inner) + 500.0, sp
        # swarp WEIGHTOUT parity: a coadd weight map rides next to each
        # stack (named weight-* so stack-* globs never ingest it);
        # equal exposures -> interior weight == stack depth
        wp = os.path.join(os.path.dirname(sp),
                          "weight-" + os.path.basename(sp)[len("stack-"):])
        assert os.path.exists(wp), wp
        wmap, whdr = read_image(wp)
        assert whdr["IMAGETYP"] == "STACK WEIGHT"
        assert wmap.shape == s.shape
        assert np.isclose(wmap[wmap.shape[0] // 2, wmap.shape[1] // 2], 4.0)

    # idempotency: a second run skips all existing outputs and succeeds
    rc2 = ap_reduce([data, cal, out, "--fixcosmic", "--skybg",
                     "-l", "ERROR"])
    assert rc2 == 0


def _navigate_dataset(tmp_path, stamp_wcs_on_first=False):
    """Masters + one group of 4 dithered lights (V)."""
    rng = np.random.default_rng(17)
    data = str(tmp_path / "data")
    cal = str(tmp_path / "cal")
    out = str(tmp_path / "out")
    os.makedirs(data)
    os.makedirs(cal)
    shape = (128, 128)
    bias = np.full(shape, 300.0, np.float32)
    h = Header()
    h["IMAGETYP"] = "MASTER BIAS"
    write_image(os.path.join(cal, "master_bias.fits"), bias, h)
    scene, truth = synth.make_starfield(shape, n_stars=8, fwhm=3.0,
                                        background=80.0, read_noise=0.0,
                                        flux_range=(20000.0, 50000.0),
                                        seed=5, min_sep=18.0)
    dithers = [(0, 0), (3, -2), (-2, 3), (1, 2)]
    for i, (dx, dy) in enumerate(dithers):
        sky = np.roll(np.roll(scene, dy, 0), dx, 1)
        img = sky + bias + rng.normal(0, 3, shape)
        h = Header()
        h["IMAGETYP"] = "Light Frame"
        h["OBJECT"] = "M42"
        h["TELESCOP"] = "T05"
        h["FILTER"] = "V"
        h["EXPTIME"] = 120.0
        if stamp_wcs_on_first and i == 0:
            _truth_wcs().to_header(h)
        write_image(os.path.join(data, f"M42-T05-V-{i:03d}.fits"),
                    img.astype(np.float32), h)
    return data, cal, out, dithers, truth


def _truth_wcs(with_sip=True):
    from astrophotography_tpu.wcs.wcs import TanWCS

    scale = 1.0 / 3600.0  # 1 arcsec/px
    sip_a = {(2, 0): 1e-6, (0, 2): -5e-7} if with_sip else None
    sip_b = {(1, 1): 4e-7} if with_sip else None
    return TanWCS((180.0, -10.0), (64.0, 64.0),
                  [[-scale, 0.0], [0.0, scale]], sip_a, sip_b)


def test_ap_reduce_navigate_stage_mock_transport(tmp_path):
    """The navigate stage (navigate_all.sh parity) with the injectable
    mock transport: nav-*.fits WCS-stamped outputs per image, ra/dec
    source columns, CRVAL/CD + SIP surviving into the stacked product's
    header, and noclean idempotency (no re-solves on the second run)."""
    from astrophotography_tpu.core.reduce import ReduceConfig, reduce_all
    from astrophotography_tpu.io.fits import open_fits

    data, cal, out, _dithers, _truth = _navigate_dataset(tmp_path)
    truth_wcs = _truth_wcs(with_sip=True)
    calls = {"n": 0}

    def mock_transport(xs, ys, w, h, hints, timeout=None):
        calls["n"] += 1
        return dict(truth_wcs.to_header().items())

    cfg = ReduceConfig(astrometry=True, astrometry_transport=mock_transport)
    produced = reduce_all(data, cal, out, cfg)
    navs = sorted(glob.glob(os.path.join(out, "nav-*.fits")))
    assert len(navs) == 4 and calls["n"] == 4
    assert sorted(produced["navigated"]) == navs
    for nv in navs:
        hdr = open_fits(nv)[0].header
        assert hdr["ASTRSOLV"] is True
        assert hdr["CRVAL1"] == 180.0 and hdr["CRVAL2"] == -10.0
        assert "CD1_1" in hdr and hdr["A_ORDER"] == 2
    # ra/dec columns added to every source list
    for src in sorted(glob.glob(os.path.join(out, "src-*.fits"))):
        xy = open_fits(src)["AP_XYPOS"]
        assert "ra" in xy.columns and "dec" in xy.columns
        assert np.all(np.isfinite(np.asarray(xy["ra"], float)))
    # CRVAL/CD/SIP survive into the stacked product
    stack = glob.glob(os.path.join(out, "stack-*.fits"))[0]
    shdr = open_fits(stack)[0].header
    assert shdr["CRVAL1"] == 180.0 and shdr["CRVAL2"] == -10.0
    assert shdr["CD1_1"] == pytest.approx(truth_wcs.cd[0, 0], rel=1e-9)
    assert shdr["A_ORDER"] == 2 and "A_2_0" in shdr
    assert shdr["ASTRSOLV"] is True

    # noclean idempotency: the second run re-solves nothing
    produced2 = reduce_all(data, cal, out, cfg)
    assert calls["n"] == 4
    assert len(produced2["navigated"]) == 4


def test_ap_reduce_navigate_local_anchor(tmp_path):
    """Network-free navigate: one WCS-bearing frame anchors
    registration-based solves for the rest of the group; the solved
    WCSs agree on the sky (the same star maps to the same RA/Dec from
    every frame)."""
    from astrophotography_tpu.core.reduce import ReduceConfig, reduce_all
    from astrophotography_tpu.io.fits import open_fits
    from astrophotography_tpu.wcs.wcs import TanWCS

    data, cal, out, dithers, truth = _navigate_dataset(
        tmp_path, stamp_wcs_on_first=True)
    cfg = ReduceConfig(astrometry=True)  # no transport: local mode
    reduce_all(data, cal, out, cfg)
    navs = sorted(glob.glob(os.path.join(out, "nav-*.fits")))
    assert len(navs) == 4
    # the same sky star lands on the same RA/Dec through every frame's
    # solved WCS (1-based pixel positions shift with the dither)
    x0, y0 = float(truth["x"][0]), float(truth["y"][0])
    radecs = []
    for nv, (dx, dy) in zip(navs, dithers):
        w = TanWCS.from_header(open_fits(nv)[0].header)
        ra, dec = w.pix2world(x0 + dx + 1.0, y0 + dy + 1.0)
        radecs.append((float(ra), float(dec)))
    ra0, dec0 = radecs[0]
    for ra, dec in radecs[1:]:
        # < 1 arcsec agreement at 1 arcsec/px scale
        assert abs(ra - ra0) * np.cos(np.radians(dec0)) * 3600 < 1.0
        assert abs(dec - dec0) * 3600 < 1.0
    # the stack (reference-frame grid) carries a WCS too
    stack = glob.glob(os.path.join(out, "stack-*.fits"))[0]
    shdr = open_fits(stack)[0].header
    assert "CRVAL1" in shdr and "CD1_1" in shdr
