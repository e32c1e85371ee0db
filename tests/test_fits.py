"""Round-trip tests for the pure-Python FITS codec."""

import numpy as np
import pytest

from astrophotography_tpu.io import (
    BinTableHDU,
    HDUList,
    Header,
    ImageHDU,
    open_fits,
    read_image,
    write_image,
)


@pytest.mark.parametrize(
    "dtype",
    [np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
     np.float32, np.float64],
)
def test_image_roundtrip_dtypes(tmp_path, dtype):
    rng = np.random.default_rng(0)
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    if info is not None:
        data = rng.integers(info.min, int(info.max) + 1 if info.bits < 64
                            else info.max, size=(13, 17), dtype=dtype)
        # include the extremes explicitly
        data[0, 0] = info.min
        data[0, 1] = info.max
    else:
        data = rng.normal(size=(13, 17)).astype(dtype)
    path = str(tmp_path / "img.fits")
    write_image(path, data)
    back, _hdr = np.asarray(open_fits(path)[0].data), open_fits(path)[0].header
    assert back.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back, data)


def test_header_value_types(tmp_path):
    hdr = Header()
    hdr["EXPTIME"] = (60.0, "exposure time [s]")
    hdr["GAIN"] = 1.5
    hdr["NFRAMES"] = 12
    hdr["CALIBRAT"] = True
    hdr["BADFLAG"] = False
    hdr["OBJECT"] = "M 42 O'Neill"
    hdr["TELESCOP"] = "T05"
    hdr["BIGNUM"] = 1.234567890123e-12
    hdr.add_history("first history line")
    hdr.add_history("second history line")
    hdr.add_comment("a comment")
    path = str(tmp_path / "hdr.fits")
    write_image(path, np.zeros((4, 4), dtype=np.float32), hdr)
    back = open_fits(path)[0].header
    assert back["EXPTIME"] == 60.0
    assert back.comments["EXPTIME"] == "exposure time [s]"
    assert back["GAIN"] == 1.5
    assert back["NFRAMES"] == 12
    assert back["CALIBRAT"] is True
    assert back["BADFLAG"] is False
    assert back["OBJECT"] == "M 42 O'Neill"
    assert back["BIGNUM"] == pytest.approx(1.234567890123e-12, rel=1e-12)
    assert back.history == ["first history line", "second history line"]


def test_gzip_roundtrip(tmp_path):
    data = np.arange(100, dtype=np.uint16).reshape(10, 10)
    for suffix in (".fits.gz", ".ftz"):
        path = str(tmp_path / f"img{suffix}")
        write_image(path, data)
        np.testing.assert_array_equal(open_fits(path)[0].data, data)


def test_multi_hdu_and_bintable(tmp_path):
    primary = ImageHDU(np.ones((8, 8), dtype=np.float32))
    ext_img = ImageHDU(np.full((4, 4), 7, dtype=np.int32), name="MASK")
    n = 5
    table = BinTableHDU(
        {
            "X": np.arange(n, dtype=np.float64) + 0.25,
            "Y": np.arange(n, dtype=np.float32) * 2,
            "ID": np.arange(n, dtype=np.int32),
            "FLAG": np.array([True, False, True, False, True]),
            "NAME": np.array(["a", "bb", "ccc", "dddd", "eeeee"]),
        },
        name="AP_XYPOS",
    )
    path = str(tmp_path / "multi.fits")
    HDUList([primary, ext_img, table]).writeto(path)
    back = open_fits(path)
    assert len(back) == 3
    np.testing.assert_array_equal(back["MASK"].data, ext_img.data)
    tab = back["AP_XYPOS"]
    np.testing.assert_allclose(tab["X"], table["X"])
    np.testing.assert_allclose(tab["Y"], table["Y"])
    np.testing.assert_array_equal(tab["ID"], table["ID"])
    np.testing.assert_array_equal(tab["FLAG"], table["FLAG"])
    assert list(tab["NAME"]) == ["a", "bb", "ccc", "dddd", "eeeee"]


def test_read_image_semantics(tmp_path):
    """read_image converts to float32 and removes PEDESTAL (reference
    core/ApCalibrate.py:260-328: PEDESTAL is the value to ADD to the
    data to remove the MaximDL offset)."""
    hdr = Header()
    hdr["PEDESTAL"] = -100
    data = np.full((6, 6), 1100, dtype=np.uint16)
    path = str(tmp_path / "ped.fits")
    write_image(path, data, hdr)
    out, outhdr = read_image(path)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.full((6, 6), 1000.0, dtype=np.float32))
    assert "PEDESTAL" not in outhdr
    assert any("PEDESTAL" in h for h in outhdr.history)


def test_read_image_rejects_3d(tmp_path):
    path = str(tmp_path / "cube.fits")
    write_image(path, np.zeros((2, 3, 4), dtype=np.float32))
    with pytest.raises(ValueError):
        read_image(path)


def test_header_update_and_delete():
    hdr = Header()
    hdr["A"] = 1
    hdr["B"] = 2
    hdr["A"] = 3
    assert hdr["A"] == 3
    assert hdr.keys() == ["A", "B"]
    del hdr["A"]
    assert "A" not in hdr
    assert hdr.keys() == ["B"]
    assert hdr["B"] == 2


def test_empty_primary_with_table(tmp_path):
    table = BinTableHDU({"V": np.array([1.0, 2.0])}, name="T")
    path = str(tmp_path / "empty.fits")
    HDUList([ImageHDU(None), table]).writeto(path)
    back = open_fits(path)
    assert back[0].data is None
    np.testing.assert_allclose(back["T"]["V"], [1.0, 2.0])


def test_int8_image_roundtrip(tmp_path):
    """int8 images use the FITS signed-byte convention (BITPIX 8,
    BZERO=-128) instead of silently wrapping negatives."""
    data = np.array([[-128, -1, 0], [1, 127, -42]], dtype=np.int8)
    path = str(tmp_path / "i8.fits")
    write_image(path, data)
    out, _ = read_image(path, as_float32=False)
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, data)


def test_read_image_device_semantics(tmp_path):
    """read_image_device transfers the native-width array and applies
    the f32 conversion + PEDESTAL on device, matching read_image."""
    import jax.numpy as jnp
    from astrophotography_tpu.io.fits import read_image_device

    rng = np.random.default_rng(3)
    img = rng.integers(-200, 4000, (32, 48)).astype(np.int16)
    hdr = Header()
    hdr["PEDESTAL"] = 100
    p = str(tmp_path / "i16.fits")
    write_image(p, img, hdr)

    host, hh = read_image(p)
    dev, hd = read_image_device(p)
    assert isinstance(dev, jnp.ndarray)
    assert dev.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(dev), host, rtol=0, atol=0)
    assert "PEDESTAL" not in hd
    assert any("PEDESTAL" in h for h in hd.history)


def test_concurrent_writes_use_distinct_temp_files(tmp_path, monkeypatch):
    """Writer threads publishing the same path never share a temp file
    (each thread's atomic rename must see its own complete file)."""
    import os
    import threading

    from astrophotography_tpu.io import fits as fits_mod

    path = str(tmp_path / "same.fits")
    tmps, barrier = [], threading.Barrier(4)
    real_replace = os.replace

    def replace(src, dst):
        tmps.append(src)
        barrier.wait(timeout=10)   # all four temp files exist at once
        real_replace(src, dst)

    monkeypatch.setattr(fits_mod.os, "replace", replace)
    threads = [threading.Thread(target=write_image,
                                args=(path, np.full((4, 4), i, np.float32)))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(tmps)) == 4
    data, _ = read_image(path)
    assert data.shape == (4, 4) and len(np.unique(data)) == 1
