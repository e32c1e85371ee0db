"""End-to-end tests for the ap_* calibration-chain CLI tools."""

import os

import numpy as np
import pytest
import yaml

from astrophotography_tpu import synth
from astrophotography_tpu.io.fits import Header, open_fits, read_image, write_image
from astrophotography_tpu.cli.ap_calibrate import main as ap_calibrate
from astrophotography_tpu.cli.ap_combine_darks import main as ap_combine_darks
from astrophotography_tpu.cli.ap_imarith import main as ap_imarith
from astrophotography_tpu.cli.ap_find_badpix import main as ap_find_badpix
from astrophotography_tpu.cli.ap_fix_badpix import main as ap_fix_badpix
from astrophotography_tpu.cli.ap_auto_badcol import main as ap_auto_badcol
from astrophotography_tpu.cli.ap_calc_read_noise import main as ap_calc_read_noise


def _write(tmp_path, name, data, **keys):
    hdr = Header()
    for k, v in keys.items():
        hdr[k] = v
    path = str(tmp_path / name)
    dtype = data.dtype if isinstance(data, np.ndarray) \
        and data.dtype.kind in "iu" else np.float32
    write_image(path, np.asarray(data, dtype), hdr)
    return path


def test_ap_combine_darks_builds_master(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "darks"
    d.mkdir()
    for i in range(6):
        img = rng.normal(500.0, 8.0, (32, 32))
        _write(d, f"dark{i}.fits", img, IMAGETYP="DARK", EXPTIME=60.0,
               **{"SET-TEMP": -10.0, "CCD-TEMP": -10.1})
    # one frame at bad temperature must be excluded
    _write(d, "dark_warm.fits", rng.normal(520.0, 8.0, (32, 32)),
           IMAGETYP="DARK", EXPTIME=60.0,
           **{"SET-TEMP": -10.0, "CCD-TEMP": -5.0})
    out = str(tmp_path / "master_dark.fits")
    assert ap_combine_darks([str(d), out, "-l", "ERROR"]) == 0
    data, hdr = read_image(out)
    assert hdr["IMAGETYP"] == "MASTER DARK"
    assert hdr["NCOMBINE"] == 6
    assert abs(float(data.mean()) - 500.0) < 2.0
    assert "IFILE000" in hdr
    # inconsistent IMAGETYP must be fatal
    _write(d, "bias_oops.fits", rng.normal(500, 8, (32, 32)),
           IMAGETYP="BIAS", EXPTIME=60.0)
    assert ap_combine_darks([str(d), out, "-l", "CRITICAL"]) == 1


def test_ap_calibrate_full_chain(tmp_path):
    rng = np.random.default_rng(1)
    shape = (48, 48)
    bias = rng.normal(300.0, 2.0, shape)
    dark_rate = np.full(shape, 1.0)
    flat = 1.0 + 0.1 * np.sin(np.arange(shape[1]) / 5.0)[None, :] * np.ones(shape)
    scene, _ = synth.make_starfield(shape, n_stars=4, background=100.0,
                                   seed=2, margin=8)
    light = (scene.astype(np.float64) * flat + bias + dark_rate * 120.0)
    bias_p = _write(tmp_path, "mbias.fits", bias, IMAGETYP="MASTER BIAS")
    dark_p = _write(tmp_path, "mdark.fits", bias + dark_rate * 60.0,
                    IMAGETYP="MASTER DARK", EXPTIME=60.0)
    flat_p = _write(tmp_path, "mflat.fits", flat * 2.0,
                    IMAGETYP="MASTER FLAT")
    light_p = _write(tmp_path, "light.fits", light, IMAGETYP="LIGHT",
                     EXPTIME=120.0)
    out = str(tmp_path / "cal.fits")
    rc = ap_calibrate([light_p, bias_p, dark_p, out,
                       "--master_flat", flat_p, "-l", "ERROR"])
    assert rc == 0
    data, hdr = read_image(out)
    assert hdr["BIASCORR"] is True
    assert hdr["DARKCORR"] is True
    assert hdr["FLATCORR"] is True
    assert hdr["BUNIT"] == "adu"
    # flat is normalized by its mean (~2.0) so division recovers the scene
    resid = data - scene
    assert abs(np.median(resid)) < 3.0


def test_ap_imarith_scalar_and_image(tmp_path):
    a = _write(tmp_path, "a.fits", np.full((8, 8), 10.0))
    b = _write(tmp_path, "b.fits", np.full((8, 8), 4.0))
    out = str(tmp_path / "o.fits")
    assert ap_imarith([a, "MUL", "2.5", out, "-l", "ERROR"]) == 0
    data, hdr = read_image(out)
    np.testing.assert_allclose(data, 25.0)
    assert any("ap_imarith" in h for h in hdr.history)
    assert ap_imarith([a, "sub", b, out, "--units", "adu", "-l", "ERROR"]) == 0
    data, hdr = read_image(out)
    np.testing.assert_allclose(data, 6.0)
    assert hdr["BUNIT"] == "adu"
    # mismatched shapes -> error exit
    c = _write(tmp_path, "c.fits", np.zeros((4, 4)))
    assert ap_imarith([a, "ADD", c, out, "-l", "CRITICAL"]) == 1


def test_ap_imarith_preserves_input_dtype(tmp_path):
    """Output dtype follows the input's (reference ApImArith.py:321):
    int16 in -> BITPIX 16 out, float32 in -> BITPIX -32 out."""
    i16 = _write(tmp_path, "i16.fits", np.full((8, 8), 7, np.int16))
    out = str(tmp_path / "o16.fits")
    assert ap_imarith([i16, "ADD", "3", out, "-l", "ERROR"]) == 0
    data, _ = read_image(out, as_float32=False)
    assert data.dtype == np.int16
    np.testing.assert_array_equal(data, 10)
    f32 = _write(tmp_path, "f32.fits", np.full((8, 8), 7.0, np.float32))
    outf = str(tmp_path / "of32.fits")
    assert ap_imarith([f32, "DIV", "2", outf, "-l", "ERROR"]) == 0
    dataf, _ = read_image(outf, as_float32=False)
    assert dataf.dtype == np.float32
    np.testing.assert_allclose(dataf, 3.5)


def test_find_and_fix_badpix_workflow(tmp_path):
    dark, hot = synth.make_dark((64, 64), n_hot=6, seed=5)
    master_p = _write(tmp_path, "mdark.fits", dark, IMAGETYP="MASTER DARK")
    user_yaml = str(tmp_path / "user.yml")
    with open(user_yaml, "w") as fh:
        yaml.safe_dump({"bad_columns": [5], "bad_rectangles": [[10, 12, 20, 21]]},
                       fh)
    mask_p = str(tmp_path / "badpix.fits")
    assert ap_find_badpix([master_p, mask_p, "--sigma", "5",
                           "--user_badpix", user_yaml, "-l", "ERROR"]) == 0
    mask, mhdr = read_image(mask_p, as_float32=False, remove_pedestal=False)
    mask = np.asarray(mask)
    # user regions can overwrite auto flags where they overlap
    assert mhdr["BPIXNAUT"] >= 5
    assert (mask[:, 4] == 2).all()          # user column (1-based 5)
    assert (mask[19:21, 9:12] == 2).all()   # rectangle xmin,xmax,ymin,ymax
    assert (mask[hot] > 0).all()

    # fix a light frame using the mask
    rng = np.random.default_rng(6)
    img = rng.normal(1000.0, 5.0, (64, 64))
    img[hot] = 60000.0
    light_p = _write(tmp_path, "light.fits", img)
    fixed_p = str(tmp_path / "fixed.fits")
    assert ap_fix_badpix([light_p, mask_p, fixed_p, "--deltapix", "2",
                          "-l", "ERROR"]) == 0
    fixed, fhdr = read_image(fixed_p)
    assert abs(fixed[hot] - 1000.0).max() < 30.0
    assert fhdr["BPIXCORR"] is True
    assert fhdr["BPIXNFIX"] > 0


def test_ap_auto_badcol_cli(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.normal(800.0, 4.0, (64, 96))
    img[:, 33] += 200.0
    p = _write(tmp_path, "m.fits", img)
    out_yaml = str(tmp_path / "cols.yml")
    assert ap_auto_badcol([p, "--output_yaml", out_yaml, "-l", "ERROR"]) == 0
    with open(out_yaml) as fh:
        data = yaml.safe_load(fh)
    assert 34 in data["bad_columns"]  # 1-based


def test_ap_calc_read_noise(tmp_path, capsys):
    rng = np.random.default_rng(8)
    rn_e, gain = 9.0, 1.5
    shape = (128, 128)
    b1 = _write(tmp_path, "b1.fits",
                rng.normal(500.0, rn_e / gain, shape), GAIN=gain)
    b2 = _write(tmp_path, "b2.fits",
                rng.normal(500.0, rn_e / gain, shape), GAIN=gain)
    assert ap_calc_read_noise([b1, b2, "-l", "ERROR"]) == 0
    out = capsys.readouterr().out
    assert "READ_NOISE=" in out
    value = float(out.split("READ_NOISE=")[1].split()[0])
    assert value == pytest.approx(rn_e, rel=0.1)


def test_ap_measure_background_odd_geometry(tmp_path):
    """Odd-sized frames must work end-to-end: the grid shrinks to the
    minimum box size (reference _set_bgbox_size fixups,
    core/ApMeasureBackground.py:255-330) and the model matches a smooth
    synthetic gradient away from sources."""
    from astrophotography_tpu.cli.ap_measure_background import (
        effective_grid, main as ap_measure_background)

    # grid fixups: box = max(48, quantum-rounded image/16), grid covers
    # the image with ceil(image/box) boxes (reference _set_bgbox_size)
    assert effective_grid(301, 457, 16, 16) == (7, 10, 48, 48)
    assert effective_grid(4008, 2672, 16, 16) == (16, 16, 252, 168)
    assert effective_grid(40, 40, 16, 16) == (1, 1, 48, 48)  # never 0 boxes
    # exactly divisible geometry still gets the reference's literal
    # floor-plus-one-quantum box (2*(1 + 1024//32) = 66, not 64)
    assert effective_grid(1024, 1024, 16, 16) == (16, 16, 66, 66)

    rng = np.random.default_rng(50)
    h, w = 301, 457  # odd, not divisible by anything convenient
    yy, xx = np.mgrid[0:h, 0:w]
    sky = 500.0 + 0.3 * xx + 0.15 * yy
    img = sky + rng.normal(0, 4.0, (h, w))
    img += synth.gaussian_star((h, w), 150.0, 220.0, 2e5, 4.0)
    inp = _write(tmp_path, "odd.fits", img)
    out = str(tmp_path / "bg.fits")
    sub = str(tmp_path / "sub.fits")
    rc = ap_measure_background([inp, out, "--subtract", sub])
    assert rc in (0, None)
    bg, hdr = read_image(out)
    assert bg.shape == (h, w)
    assert hdr["IMAGETYP"] == "Background Sky"
    # model within a few ADU of the true sky away from the star
    far = np.ones((h, w), bool)
    far[120:180, 190:250] = False
    err = np.abs(bg - sky)[far]
    assert np.median(err) < 3.0
    sub_img, _ = read_image(sub)
    assert abs(np.median(sub_img[far])) < 3.0


@pytest.mark.slow
def test_ap_stack_cli(tmp_path):
    """ap_stack: the standalone register+stack tool (the reference's
    swarp resample+combine role, scripts/resample_all.sh:62-79)."""
    import jax.numpy as jnp
    from astrophotography_tpu import synth
    from astrophotography_tpu.cli.ap_stack import main as ap_stack

    rng = np.random.default_rng(60)
    img, _ = synth.make_starfield((128, 128), n_stars=8, fwhm=3.0,
                                  background=120.0, read_noise=4.0,
                                  flux_range=(20000.0, 50000.0), seed=60,
                                  min_sep=14.0)
    paths = []
    for i in range(4):
        dx, dy = (0, 0) if i == 0 else rng.integers(-3, 4, 2)
        fr = (np.roll(np.roll(img, dy, 0), dx, 1)
              + rng.normal(0, 3, img.shape)).astype(np.float32)
        # frame 2 at double exposure: FSCALE must normalize it
        if i == 2:
            fr = fr * 2.0
        hdr = Header()
        hdr["EXPTIME"] = 120.0 if i == 2 else 60.0
        p = str(tmp_path / f"cal-{i}.fits")
        write_image(p, fr, hdr)
        paths.append(p)
    out = str(tmp_path / "stack.fits")
    wout = str(tmp_path / "stack.weight.fits")
    rc = ap_stack(paths + ["-o", out, "-l", "ERROR",
                           "--weight_out", wout])
    assert rc == 0
    s, hdr = read_image(out)
    assert hdr["IMAGETYP"] == "STACK"
    assert hdr["NSTACK"] == 4
    assert hdr["EXPTOTAL"] == 300.0
    # FSCALE normalized the double-exposure frame: background stays ~120
    inner = s[30:-30, 30:-30]
    assert abs(np.median(inner) - 120.0) < 6.0
    # swarp-style weight map (WEIGHTOUT role): interior = sum of frame
    # weights, where the fscale=0.5 double-exposure frame carries
    # 1/fscale^2 = 4 (inverse variance); borders outside every frame's
    # tap footprint carry zero
    wmap, whdr = read_image(wout)
    assert whdr["IMAGETYP"] == "STACK WEIGHT"
    assert wmap.shape == s.shape
    assert np.isclose(wmap[64, 64], 1.0 + 1.0 + 4.0 + 1.0)
    # the reference frame's own tap footprint excludes its first two
    # columns/rows, so the corner can never reach the interior's total
    # (dithered-inward frames may still legitimately cover it)
    assert wmap[0, 0] < wmap[64, 64]


@pytest.mark.slow
def test_ap_stack_union_canvas(tmp_path):
    """--canvas union builds an output grid covering every registered
    frame (the swarp mosaic behavior): frames dithered by +-40 px all
    land fully inside the canvas with their mutual overlap stacked."""
    from astrophotography_tpu import synth
    from astrophotography_tpu.cli.ap_stack import main as ap_stack

    rng = np.random.default_rng(61)
    h, w = 160, 160
    img, truth = synth.make_starfield((h, w), n_stars=12, fwhm=3.0,
                                      background=100.0, read_noise=4.0,
                                      flux_range=(20000.0, 50000.0),
                                      seed=61, min_sep=13.0)
    paths = []
    offs = [(0, 0), (40, 0), (-40, 35)]
    for i, (dx, dy) in enumerate(offs):
        fr = (np.roll(np.roll(img, dy, 0), dx, 1)
              + rng.normal(0, 3, img.shape)).astype(np.float32)
        hdr = Header()
        hdr["EXPTIME"] = 60.0
        p = str(tmp_path / f"m-{i}.fits")
        write_image(p, fr, hdr)
        paths.append(p)
    out = str(tmp_path / "mosaic.fits")
    wout = str(tmp_path / "mosaic.weight.fits")
    rc = ap_stack(paths + ["-o", out, "--canvas", "union", "-l", "ERROR",
                           "--weight_out", wout])
    assert rc == 0
    s, hdr = read_image(out)
    # canvas spans the union: at least frame + 75 px in x, + 35 in y
    assert s.shape[1] >= w + 75 and s.shape[0] >= h + 30
    assert "CANVASY0" in hdr and "CANVASX0" in hdr
    # covered region is background-level, uncovered is exactly zero
    covered = s != 0.0
    assert covered.mean() > 0.5
    assert abs(np.median(s[covered]) - 100.0) < 5.0
    # reference stars appear at (x - CANVASX0, y - CANVASY0)
    from astrophotography_tpu.ops import find_stars, sigma_clipped_stats
    _, med, std = (float(v) for v in sigma_clipped_stats(s, sigma=3.0))
    det = find_stars(s - med, fwhm=3.0, threshold=7.0 * std, max_stars=64)
    v = np.asarray(det.valid)
    dx_, dy_ = np.asarray(det.x)[v], np.asarray(det.y)[v]
    x0, y0 = hdr["CANVASX0"], hdr["CANVASY0"]
    matched = sum(1 for x, y in zip(truth["x"], truth["y"])
                  if np.hypot(dx_ - (x - x0), dy_ - (y - y0)).min() < 1.0)
    assert matched >= len(truth["x"]) - 1
    # weight map on the union canvas: 3 in the triple overlap, 0 where
    # no frame's footprint reaches, and > 0 wherever data landed
    wmap, _ = read_image(wout)
    assert wmap.shape == s.shape
    assert np.isclose(wmap.max(), 3.0) and (wmap == 3.0).sum() > 100
    assert np.all(wmap[s != 0.0] > 0.0)
    assert (wmap == 0.0).any()
