"""End-to-end tests for the batch reduction driver and compositing."""

import os

import numpy as np
import pytest

# multi-stage CLI soak runs: full-suite tier
pytestmark = pytest.mark.slow

from astrophotography_tpu import synth
from astrophotography_tpu.io.fits import Header, read_image, write_image
from astrophotography_tpu.cli.ap_reduce import main as ap_reduce
from astrophotography_tpu.cli.ap_composite import main as ap_composite


def _make_dataset(tmp_path, n_frames=3):
    """Synthetic observing run: masters + dithered lights of one field."""
    rng = np.random.default_rng(50)
    shape = (128, 128)
    caldir = tmp_path / "cal"
    datadir = tmp_path / "data"
    caldir.mkdir()
    datadir.mkdir()

    bias = rng.normal(300.0, 2.0, shape).astype(np.float32)
    hdr = Header()
    hdr["IMAGETYP"] = "MASTER BIAS"
    write_image(str(caldir / "master_bias.fits"), bias, hdr)

    dark = bias + 60.0 * 0.5
    dhdr = Header()
    dhdr["IMAGETYP"] = "MASTER DARK"
    dhdr["EXPTIME"] = 60.0
    write_image(str(caldir / "master_dark.fits"), dark.astype(np.float32), dhdr)

    # star field, dithered
    base_x = rng.uniform(20, 108, 10)
    base_y = rng.uniform(20, 108, 10)
    flux = rng.uniform(30000, 80000, 10)
    for i in range(n_frames):
        dx, dy = (rng.uniform(-3, 3, 2) if i else (0.0, 0.0))
        img = np.full(shape, 150.0)
        for x, y, f in zip(base_x + dx, base_y + dy, flux):
            img += synth.gaussian_star(shape, x, y, f, 3.0)
        img = rng.poisson(img).astype(np.float32)
        img += bias + 30.0  # 60s-dark at ratio 1
        lhdr = Header()
        lhdr["IMAGETYP"] = "LIGHT"
        lhdr["EXPTIME"] = 60.0
        lhdr["OBJECT"] = "TestField"
        lhdr["TELESCOP"] = "T05"
        lhdr["FILTER"] = "V"
        lhdr["DATE-OBS"] = f"2026-08-01T0{i}:00:00"
        write_image(str(datadir / f"light{i:02d}.fits"), img, lhdr)
    return datadir, caldir, (base_x, base_y)


def test_ap_reduce_end_to_end(tmp_path):
    datadir, caldir, (bx, by) = _make_dataset(tmp_path)
    outdir = tmp_path / "out"
    rc = ap_reduce([str(datadir), str(caldir), str(outdir), "-l", "ERROR"])
    assert rc == 0
    cal_files = sorted(os.listdir(outdir))
    assert any(f.startswith("cal-light") for f in cal_files)
    assert any(f.startswith("qual_") for f in cal_files)
    stacks = [f for f in cal_files if f.startswith("stack-")]
    assert len(stacks) == 1
    stack, shdr = read_image(str(outdir / stacks[0]))
    assert shdr["IMAGETYP"] == "STACK"
    assert shdr["NSTACK"] == 3
    assert shdr["EXPTOTAL"] == 180.0
    # swarp WEIGHTOUT parity: a weight-* coadd weight map rides next to
    # the stack (named so stack-* globs never ingest it), equal
    # exposures -> interior weight == stack depth
    weights = [f for f in cal_files if f.startswith("weight-")]
    assert weights == ["weight-" + stacks[0][len("stack-"):]]
    wmap, whdr = read_image(str(outdir / weights[0]))
    assert whdr["IMAGETYP"] == "STACK WEIGHT"
    assert wmap.shape == stack.shape
    assert np.isclose(wmap[wmap.shape[0] // 2, wmap.shape[1] // 2], 3.0)
    # stars present at reference positions
    from astrophotography_tpu.ops import find_stars, sigma_clipped_stats
    _, med, std = (float(v) for v in sigma_clipped_stats(stack, sigma=3.0))
    stars = find_stars(stack - med, fwhm=3.0, threshold=7.0 * std,
                       max_stars=32)
    v = np.asarray(stars.valid)
    dx = np.asarray(stars.x)[v]
    dy = np.asarray(stars.y)[v]
    found = sum(1 for x, y in zip(bx, by)
                if np.hypot(dx - x, dy - y).min() < 1.5)
    assert found >= 9
    # calibration removed the bias: background near injected sky level
    assert abs(med - 150.0) < 15.0

    # noclean: second run skips everything, exit 0
    mtimes = {f: os.path.getmtime(outdir / f) for f in cal_files}
    rc2 = ap_reduce([str(datadir), str(caldir), str(outdir), "-l", "ERROR"])
    assert rc2 == 0
    for f in cal_files:
        assert os.path.getmtime(outdir / f) == mtimes[f]


def test_ap_composite_cli(tmp_path):
    rng = np.random.default_rng(60)
    shape = (64, 64)
    chans = {}
    for name, level in (("r", 1000), ("g", 2000), ("b", 1500)):
        img = rng.normal(level, 50, shape).astype(np.float32)
        img += synth.gaussian_star(shape, 32, 32, 500000.0, 4.0).astype(np.float32)
        p = str(tmp_path / f"{name}.fits")
        write_image(p, img, Header())
        chans[name] = p
    out = str(tmp_path / "color.png")
    rc = ap_composite([chans["r"], chans["g"], chans["b"], out, "-l", "ERROR"])
    assert rc == 0
    import imageio.v3 as iio
    img = iio.imread(out)
    assert img.shape == (64, 64, 3)
    assert img.dtype == np.uint8
    # star core is bright in all channels
    assert (img[32, 32] > 200).all()
    # 16-bit TIFF output
    out16 = str(tmp_path / "color.tiff")
    rc = ap_composite([chans["r"], chans["g"], chans["b"], out16,
                       "--bits", "16", "--mode", "gamma", "-l", "ERROR"])
    assert rc == 0
    img16 = iio.imread(out16)
    assert img16.dtype == np.uint16
