"""Pure-Python FITS reader/writer.

The reference delegates all FITS I/O to astropy.io.fits and copy-pastes
``_read_fits`` (uint->float32 conversion, PEDESTAL removal, BSCALE/BZERO
handling, 3-D rejection) into 8+ classes (see e.g. reference
core/ApCalibrate.py:260-328).  This module is the single FITS codec for
the whole framework, implemented against the FITS 4.0 standard:

* primary + IMAGE extension HDUs, BITPIX 8/16/32/64/-32/-64,
  BSCALE/BZERO integer scaling (unsigned 16/32-bit convention);
* BINTABLE extensions with L/B/I/J/K/E/D/A column formats (enough for
  source lists — reference writes AP_XYPOS et al. as bintables,
  core/ApFindStars.py:627-678);
* ordered headers with comments, HISTORY/COMMENT cards;
* transparent gzip for ``.gz``/``.ftz`` paths.

It is intentionally small: no CONTINUE long-strings, no random groups,
no ASCII tables, no variable-length arrays, no checksums.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

# numpy kind/itemsize -> (BITPIX, BZERO) for the unsigned-int convention
_UNSIGNED_BZERO = {1: 0, 2: 32768, 4: 2147483648, 8: 9223372036854775808}


# --------------------------------------------------------------------------
# Header
# --------------------------------------------------------------------------

class Header:
    """Ordered FITS header: keyword -> (value, comment) plus commentary cards.

    Behaves like a mapping for value access (``hdr['EXPTIME']``) while
    preserving card order and comments for round-tripping.
    """

    def __init__(self, items: Optional[Sequence[Tuple[str, Any]]] = None) -> None:
        # each card: (keyword, value, comment); commentary cards use
        # keyword in {'HISTORY','COMMENT',''} and value=str text.
        self._cards: List[Tuple[str, Any, str]] = []
        self._index: Dict[str, int] = {}
        if items:
            for k, v in items:
                self[k] = v

    # -- mapping interface -------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key.upper() in self._index

    def __getitem__(self, key: str) -> Any:
        return self._cards[self._index[key.upper()]][1]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key: str, value: Any) -> None:
        comment = ""
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
        key = key.upper()
        if key in ("HISTORY", "COMMENT", ""):
            self._cards.append((key, str(value), ""))
            return
        if key in self._index:
            idx = self._index[key]
            old_comment = self._cards[idx][2]
            self._cards[idx] = (key, value, comment or old_comment)
        else:
            self._index[key] = len(self._cards)
            self._cards.append((key, value, comment))

    def __delitem__(self, key: str) -> None:
        key = key.upper()
        idx = self._index.pop(key)
        del self._cards[idx]
        for k, i in self._index.items():
            if i > idx:
                self._index[k] = i - 1

    def __iter__(self) -> Iterator[str]:
        for k, _v, _c in self._cards:
            if k not in ("HISTORY", "COMMENT", ""):
                yield k

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return list(iter(self))

    def items(self):
        return [(k, self[k]) for k in self]

    # -- commentary --------------------------------------------------------
    def add_history(self, text: str) -> None:
        self["HISTORY"] = text

    def add_comment(self, text: str) -> None:
        self["COMMENT"] = text

    @property
    def history(self) -> List[str]:
        return [v for k, v, _ in self._cards if k == "HISTORY"]

    @property
    def comments(self) -> Dict[str, str]:
        return {k: c for k, v, c in self._cards if k not in ("HISTORY", "COMMENT", "")}

    def set_comment(self, key: str, comment: str) -> None:
        idx = self._index[key.upper()]
        k, v, _ = self._cards[idx]
        self._cards[idx] = (k, v, comment)

    def copy(self) -> "Header":
        out = Header()
        out._cards = list(self._cards)
        out._index = dict(self._index)
        return out

    def update(self, other: Union["Header", Dict[str, Any]]) -> None:
        if isinstance(other, Header):
            for k, v, c in other._cards:
                self[k] = (v, c) if k not in ("HISTORY", "COMMENT", "") else v
        else:
            for k, v in other.items():
                self[k] = v

    # -- serialization -----------------------------------------------------
    def _cards_bytes(self) -> bytes:
        out = bytearray()
        for k, v, c in self._cards:
            out += _format_card(k, v, c)
        out += b"END" + b" " * (CARD - 3)
        pad = (-len(out)) % BLOCK
        out += b" " * pad
        return bytes(out)

    @classmethod
    def _from_blocks(cls, raw: bytes) -> "Header":
        hdr = cls()
        for off in range(0, len(raw), CARD):
            card = raw[off:off + CARD].decode("latin-1")
            key = card[:8].strip()
            if key == "END":
                break
            if card[8:10] == "= " and key not in ("HISTORY", "COMMENT"):
                value, comment = _parse_value(card[10:])
                if key in hdr._index:
                    # duplicate keyword: keep first occurrence
                    continue
                hdr._index[key] = len(hdr._cards)
                hdr._cards.append((key, value, comment))
            elif key in ("HISTORY", "COMMENT"):
                hdr._cards.append((key, card[8:].rstrip(), ""))
            # blank/other commentary cards are dropped
        return hdr

    def __repr__(self) -> str:
        return f"Header({len(self._cards)} cards)"


def _format_card(key: str, value: Any, comment: str) -> bytes:
    if len(key) > 8:
        raise ValueError(f"FITS keyword {key!r} exceeds 8 characters")
    if key in ("HISTORY", "COMMENT", ""):
        text = str(value)[: CARD - 8]
        return (f"{key:<8}{text}").ljust(CARD).encode("latin-1")
    if isinstance(value, bool):
        vstr = "T" if value else "F"
        body = f"{key:<8}= {vstr:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        vstr = _format_float(float(value))
        body = f"{key:<8}= {vstr:>20}"
    elif value is None:
        body = f"{key:<8}= {'':>20}"
    else:  # string
        s = str(value).replace("'", "''")[:68]
        # minimum 8 chars inside the quotes per the standard
        vstr = f"'{s:<8}'"
        body = f"{key:<8}= {vstr:<20}"
    if comment:
        body = f"{body} / {comment}"
    return body[:CARD].ljust(CARD).encode("latin-1")


def _format_float(x: float) -> str:
    if x != x or x in (float("inf"), float("-inf")):
        raise ValueError("FITS headers cannot store NaN/Inf values")
    s = repr(x)
    if len(s) > 20:
        s = f"{x:.16G}"
        if len(s) > 20:
            s = f"{x:.13G}"
    if "." not in s and "E" not in s and "e" not in s:
        s += ".0"
    return s.upper()


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([EDed][+-]?\d+)?$")


def _parse_value(rest: str) -> Tuple[Any, str]:
    rest = rest.rstrip()
    if rest.lstrip().startswith("'"):
        # string value; handle '' escapes
        s = rest.lstrip()
        chars: List[str] = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    chars.append("'")
                    i += 2
                    continue
                break
            chars.append(s[i])
            i += 1
        after = s[i + 1:]
        comment = ""
        slash = after.find("/")
        if slash >= 0:
            comment = after[slash + 1:].strip()
        return "".join(chars).rstrip(), comment
    # non-string: value terminated by optional /comment
    slash = rest.find("/")
    comment = rest[slash + 1:].strip() if slash >= 0 else ""
    vstr = (rest[:slash] if slash >= 0 else rest).strip()
    if vstr == "":
        return None, comment
    if vstr == "T":
        return True, comment
    if vstr == "F":
        return False, comment
    if _NUM_RE.match(vstr):
        v = vstr.upper().replace("D", "E")
        try:
            if re.match(r"^[+-]?\d+$", vstr):
                return int(vstr), comment
            return float(v), comment
        except ValueError:
            pass
    return vstr, comment


# --------------------------------------------------------------------------
# HDUs
# --------------------------------------------------------------------------

class ImageHDU:
    """Image HDU (primary or IMAGE extension)."""

    def __init__(
        self,
        data: Optional[np.ndarray] = None,
        header: Optional[Header] = None,
        name: Optional[str] = None,
    ) -> None:
        self.data = data
        self.header = header if header is not None else Header()
        if name:
            self.header["EXTNAME"] = name

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", ""))

    def _data_bytes(self) -> Tuple[Header, bytes]:
        hdr = self.header.copy()
        for k in ("SIMPLE", "XTENSION", "BITPIX", "NAXIS", "BSCALE", "BZERO",
                  "PCOUNT", "GCOUNT", "EXTEND"):
            if k in hdr:
                del hdr[k]
        for k in list(hdr):
            if re.match(r"^NAXIS\d+$", k):
                del hdr[k]
        if self.data is None:
            return hdr, b""
        data = np.asarray(self.data)
        bzero = 0
        if data.dtype == np.dtype("i1"):
            # FITS has no signed 8-bit type; the convention is BITPIX 8
            # with BZERO=-128 (stored = value + 128 as unsigned)
            bzero = -128
            data = (data.view("u1") + np.uint8(128)).astype("u1")
        if data.dtype.kind == "u" and data.dtype.itemsize > 1:
            size = data.dtype.itemsize
            bzero = _UNSIGNED_BZERO[size]
            # stored = (value - BZERO) mod 2^n reinterpreted as signed;
            # unsigned wraparound makes this exact for every width incl. 64-bit
            shifted = data.astype(f"u{size}") - np.array(bzero, dtype=f"u{size}")
            data = shifted.view(f"i{size}")
        elif data.dtype == np.dtype("bool"):
            data = data.astype(">u1")
        # map to big-endian FITS dtype
        kind, size = data.dtype.kind, data.dtype.itemsize
        if kind in "iu":
            bitpix = size * 8
            fits_dtype = np.dtype(f">i{size}") if size > 1 else np.dtype(">u1")
        elif kind == "f":
            if size < 4:
                data = data.astype(">f4")
                size = 4
            bitpix = -size * 8
            fits_dtype = np.dtype(f">f{size}")
        else:
            raise TypeError(f"cannot store dtype {data.dtype} in FITS image")
        payload = np.ascontiguousarray(data.astype(fits_dtype, copy=False)).tobytes()
        meta = Header()
        meta["BITPIX"] = (bitpix, "array data type")
        meta["NAXIS"] = (data.ndim, "number of array dimensions")
        for i, n in enumerate(reversed(data.shape)):
            meta[f"NAXIS{i + 1}"] = int(n)
        if bzero:
            meta["BSCALE"] = 1
            meta["BZERO"] = bzero
        meta.update(hdr)
        return meta, payload


class BinTableHDU:
    """Binary table HDU built from named 1-D (or fixed-width 2-D) columns."""

    def __init__(
        self,
        columns: Optional[Dict[str, np.ndarray]] = None,
        header: Optional[Header] = None,
        name: Optional[str] = None,
    ) -> None:
        self.columns: Dict[str, np.ndarray] = dict(columns or {})
        self.header = header if header is not None else Header()
        if name:
            self.header["EXTNAME"] = name

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", ""))

    @property
    def data(self) -> Dict[str, np.ndarray]:
        return self.columns

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    _TFORM_MAP = {
        "b": ("L", np.dtype("u1")),
        "u1": ("B", np.dtype("u1")),
        "i2": ("I", np.dtype(">i2")),
        "i4": ("J", np.dtype(">i4")),
        "i8": ("K", np.dtype(">i8")),
        "f4": ("E", np.dtype(">f4")),
        "f8": ("D", np.dtype(">f8")),
    }

    def _data_bytes(self) -> Tuple[Header, bytes]:
        names = list(self.columns)
        arrays = []
        tforms = []
        dtypes = []
        nrows = None
        for name in names:
            arr = np.asarray(self.columns[name])
            if nrows is None:
                nrows = len(arr)
            elif len(arr) != nrows:
                raise ValueError("all table columns must have equal length")
            if arr.dtype.kind in "US":
                width = arr.dtype.itemsize if arr.dtype.kind == "S" else (
                    arr.dtype.itemsize // 4)
                width = max(width, 1)
                arr = np.array([str(x)[:width].encode("latin-1") for x in arr],
                               dtype=f"S{width}")
                tforms.append(f"{width}A")
                dtypes.append((name, f"S{width}"))
            else:
                if arr.dtype == np.dtype("bool"):
                    code, dt = self._TFORM_MAP["b"]
                    arr = np.where(arr, ord("T"), ord("F")).astype("u1")
                else:
                    key = f"{arr.dtype.kind}{arr.dtype.itemsize}"
                    if key in ("u2", "u4", "u8"):
                        arr = arr.astype(f">i{min(arr.dtype.itemsize * 2, 8)}")
                        key = f"i{arr.dtype.itemsize}"
                    if key in ("f2",):
                        arr = arr.astype(">f4")
                        key = "f4"
                    if key not in self._TFORM_MAP:
                        raise TypeError(f"unsupported column dtype {arr.dtype}")
                    code, dt = self._TFORM_MAP[key]
                    arr = arr.astype(dt)
                repeat = 1 if arr.ndim == 1 else int(np.prod(arr.shape[1:]))
                tforms.append(f"{repeat}{code}" if repeat != 1 else code)
                dtypes.append((name, arr.dtype.str if arr.ndim == 1
                               else (arr.dtype.str, arr.shape[1:])))
            arrays.append(arr)
        nrows = nrows or 0
        rec = np.zeros(nrows, dtype=dtypes)
        for name, arr in zip(names, arrays):
            rec[name] = arr
        payload = rec.tobytes()

        meta = Header()
        meta["BITPIX"] = (8, "array data type")
        meta["NAXIS"] = (2, "number of array dimensions")
        meta["NAXIS1"] = (rec.dtype.itemsize, "length of dimension 1")
        meta["NAXIS2"] = (nrows, "length of dimension 2")
        meta["PCOUNT"] = (0, "number of group parameters")
        meta["GCOUNT"] = (1, "number of groups")
        meta["TFIELDS"] = (len(names), "number of table fields")
        for i, (name, tform) in enumerate(zip(names, tforms), start=1):
            meta[f"TTYPE{i}"] = name
            meta[f"TFORM{i}"] = tform
        hdr = self.header.copy()
        for k in list(hdr):
            if re.match(r"^(XTENSION|BITPIX|NAXIS\d*|PCOUNT|GCOUNT|TFIELDS)$", k) \
                    or re.match(r"^T(TYPE|FORM|UNIT|NULL|SCAL|ZERO|DIM)\d+$", k):
                del hdr[k]
        meta.update(hdr)
        return meta, payload

    _TFORM_RE = re.compile(r"^(\d*)([LXBIJKAEDCMPQ])")

    @classmethod
    def _from_parts(cls, header: Header, payload: bytes) -> "BinTableHDU":
        tfields = int(header["TFIELDS"])
        nrows = int(header["NAXIS2"])
        names = []
        dtypes = []
        str_cols = set()
        bool_cols = set()
        for i in range(1, tfields + 1):
            name = str(header[f"TTYPE{i}"]).strip()
            tform = str(header[f"TFORM{i}"]).strip()
            m = cls._TFORM_RE.match(tform)
            if not m:
                raise ValueError(f"unsupported TFORM {tform!r}")
            repeat = int(m.group(1)) if m.group(1) else 1
            code = m.group(2)
            base = {"L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
                    "E": ">f4", "D": ">f8", "A": f"S{repeat}"}.get(code)
            if base is None:
                raise ValueError(f"unsupported TFORM code {code!r}")
            if code == "A":
                dtypes.append((name, base))
                str_cols.add(name)
            elif repeat == 1:
                dtypes.append((name, base))
            else:
                dtypes.append((name, base, (repeat,)))
            if code == "L":
                bool_cols.add(name)
            names.append(name)
        rec = np.frombuffer(payload[: nrows * np.dtype(dtypes).itemsize],
                            dtype=dtypes).copy()
        cols: Dict[str, np.ndarray] = {}
        for name in names:
            arr = rec[name]
            if name in str_cols:
                arr = np.array([x.decode("latin-1").rstrip() for x in arr])
            elif name in bool_cols:
                arr = arr == ord("T")
            else:
                arr = arr.astype(arr.dtype.newbyteorder("="))
            cols[name] = arr
        hdr = header.copy()
        return cls(cols, hdr)


HDU = Union[ImageHDU, BinTableHDU]


class HDUList(list):
    """List of HDUs with by-name lookup and file output."""

    def __getitem__(self, key):  # type: ignore[override]
        if isinstance(key, str):
            for hdu in self:
                if hdu.name.upper() == key.upper():
                    return hdu
            raise KeyError(key)
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:  # type: ignore[override]
        if isinstance(key, str):
            return any(h.name.upper() == key.upper() for h in self)
        return super().__contains__(key)

    def writeto(self, path: str, overwrite: bool = True) -> None:
        if not overwrite and os.path.exists(path):
            raise FileExistsError(path)
        raw = self.tobytes()  # serialize fully before touching the path
        # atomic publish: write a same-directory temp file and rename
        # over the target, so an interrupted write never leaves a
        # partial (unreadable) FITS file at the destination.  The name
        # is unique per process AND thread: writer threads may publish
        # the same path concurrently
        tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}"
        try:
            if path.endswith(".gz") or path.endswith(".ftz"):
                with gzip.open(tmp, "wb") as fh:
                    fh.write(raw)
            else:
                with open(tmp, "wb") as fh:
                    fh.write(raw)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def tobytes(self) -> bytes:
        """Serialize the HDU list to in-memory FITS bytes."""
        buf = _io.BytesIO()
        for i, hdu in enumerate(self):
            meta, payload = hdu._data_bytes()
            full = Header()
            if i == 0:
                if isinstance(hdu, BinTableHDU):
                    raise TypeError("primary HDU must be an image")
                full["SIMPLE"] = (True, "conforms to FITS standard")
                if hdu.data is None:
                    full["BITPIX"] = (8, "array data type")
                    full["NAXIS"] = (0, "number of array dimensions")
                full.update(meta)
                full["EXTEND"] = True
            else:
                full["XTENSION"] = (
                    "BINTABLE" if isinstance(hdu, BinTableHDU) else "IMAGE",
                    "extension type")
                if hdu.data is None:
                    full["BITPIX"] = 8
                    full["NAXIS"] = 0
                full.update(meta)
                if "PCOUNT" not in full:
                    full["PCOUNT"] = 0
                if "GCOUNT" not in full:
                    full["GCOUNT"] = 1
            buf.write(full._cards_bytes())
            buf.write(payload)
            buf.write(b"\0" * ((-len(payload)) % BLOCK))
        return buf.getvalue()


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

def _read_exact(fh, n: int, _chunk: int = 1 << 26) -> bytes:
    """Read exactly ``n`` bytes or raise EOFError.

    Reads in bounded chunks so a corrupt header claiming a terabyte
    payload (absurd NAXISn) fails with EOFError when the file runs out
    instead of MemoryError trying to allocate the claimed size."""
    if n < 0:
        raise ValueError(f"negative FITS payload size {n}")
    parts = []
    got = 0
    while got < n:
        piece = fh.read(min(_chunk, n - got))
        if not piece:
            raise EOFError("truncated FITS file")
        parts.append(piece)
        got += len(piece)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def open_fits(path: str) -> HDUList:
    """Read all HDUs of a FITS file (optionally gzipped)."""
    opener = gzip.open if (path.endswith(".gz") or path.endswith(".ftz")) else open
    with opener(path, "rb") as fh:
        return _open_fits_stream(fh, name=path)


def open_fits_bytes(data: bytes) -> HDUList:
    """Read all HDUs from an in-memory FITS byte string (e.g. a
    downloaded astrometry.net ``wcs_file``)."""
    import io as _io

    return _open_fits_stream(_io.BytesIO(data), name="<bytes>")


def _open_fits_stream(fh, name: str = "<stream>") -> HDUList:
    hdus = HDUList()
    first = True
    while True:
        block = fh.read(BLOCK)
        if not block:
            break
        if len(block) < BLOCK:
            if block.strip(b"\0 ") == b"":
                break
            raise EOFError("truncated FITS header")
        if first and not (block.startswith(b"SIMPLE  ")
                          or block.startswith(b"XTENSION")):
            # a conforming file's first card is SIMPLE (or XTENSION for
            # a bare extension stream); rejecting here keeps arbitrary
            # binary garbage from being block-scanned for an END card
            raise ValueError(f"{name!r} is not a FITS file")
        raw = bytearray(block)
        while b"END" not in _end_cards(bytes(raw)):
            raw += _read_exact(fh, BLOCK)
        header = Header._from_blocks(bytes(raw))
        if first and header.get("SIMPLE") is None and "XTENSION" not in header:
            raise ValueError(f"{name!r} is not a FITS file")
        first = False
        xt = str(header.get("XTENSION", "")).strip().upper()
        naxis = int(header.get("NAXIS", 0))
        if not 0 <= naxis <= 999:
            raise ValueError(f"{name!r}: NAXIS {naxis} outside 0..999")
        try:
            shape = tuple(int(header[f"NAXIS{i}"])
                          for i in range(naxis, 0, -1))
        except KeyError as exc:
            raise ValueError(
                f"{name!r}: NAXIS={naxis} but card {exc.args[0]!r} "
                "is missing") from None
        if any(s < 0 for s in shape):
            raise ValueError(f"{name!r}: negative axis length in {shape}")
        bitpix = int(header.get("BITPIX", 8))
        if bitpix not in _BITPIX_DTYPE:
            raise ValueError(f"{name!r}: unsupported BITPIX {bitpix}")
        pcount = int(header.get("PCOUNT", 0))
        if pcount < 0:
            raise ValueError(f"{name!r}: negative PCOUNT {pcount}")
        nbytes = int(abs(bitpix) // 8 * int(np.prod(shape, dtype=np.int64)) if shape else 0)
        nbytes += pcount * (abs(bitpix) // 8)
        payload = _read_exact(fh, nbytes) if nbytes else b""
        if nbytes:
            fh.read((-nbytes) % BLOCK)  # discard padding
        if xt == "BINTABLE":
            hdus.append(BinTableHDU._from_parts(header, payload))
        else:
            data = None
            if shape:
                data = np.frombuffer(payload, dtype=_BITPIX_DTYPE[bitpix]) \
                    .reshape(shape).copy()
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                if bitpix > 0 and bscale == 1 and bzero == _UNSIGNED_BZERO.get(
                        bitpix // 8, None):
                    # unsigned-int convention: value = (stored + BZERO) mod 2^n
                    size = bitpix // 8
                    data = (data.astype(f"i{size}").view(f"u{size}")
                            + np.array(bzero, dtype=f"u{size}"))
                elif bitpix == 8 and bscale == 1 and bzero == -128:
                    # signed-byte convention: value = stored - 128
                    data = (data - np.uint8(128)).view("i1")
                elif bscale != 1 or bzero != 0:
                    data = data * float(bscale) + float(bzero)
                else:
                    data = data.astype(data.dtype.newbyteorder("="))
                for k in ("BSCALE", "BZERO"):
                    if k in header:
                        del header[k]
            hdus.append(ImageHDU(data, header))
    if not hdus:
        raise ValueError(f"{name!r} contains no HDUs")
    return hdus


def _end_cards(raw: bytes) -> set:
    return {raw[o:o + 8].rstrip() for o in range(0, len(raw), CARD)}


# --------------------------------------------------------------------------
# Convenience: the reference's canonical read/write semantics
# --------------------------------------------------------------------------

def read_image_device(path: str, ext: int = 0):
    """Read a 2-D image straight onto the accelerator.

    Like :func:`read_image`, but the array is transferred to the
    default device at its NATIVE width and converted to float32 (and
    PEDESTAL-corrected) on device — 16-bit detector frames cross the
    host->device link at half the bytes of a pre-converted f32 array.
    Returns (device f32 array, Header).
    """
    import jax.numpy as jnp

    data, hdr = read_image(path, ext=ext, as_float32=False,
                           remove_pedestal=False)
    dev = jnp.asarray(data).astype(jnp.float32)
    if "PEDESTAL" in hdr:
        pedestal = float(hdr["PEDESTAL"])
        if pedestal != 0:
            dev = dev + np.float32(pedestal)
            del hdr["PEDESTAL"]
            hdr.add_history(
                f"Removed PEDESTAL of {pedestal} ADU from data")
    return dev, hdr


def read_image(
    path: str,
    ext: int = 0,
    as_float32: bool = True,
    remove_pedestal: bool = True,
) -> Tuple[np.ndarray, Header]:
    """Read a 2-D image implementing the reference ``_read_fits`` semantics.

    Reference core/ApCalibrate.py:260-328: select first HDU with data,
    reject non-2-D arrays, convert unsigned ints to float32, and remove
    the PEDESTAL keyword value from the data (reference :318-326).
    """
    hdus = open_fits(path)
    hdu = hdus[ext]
    if hdu.data is None:
        for cand in hdus:
            if isinstance(cand, ImageHDU) and cand.data is not None:
                hdu = cand
                break
    if hdu.data is None:
        raise ValueError(f"{path!r} has no image data")
    data = hdu.data
    if data.ndim != 2:
        raise ValueError(
            f"{path!r} has {data.ndim}-dimensional data; only 2-D images supported")
    header = hdu.header
    if as_float32 and data.dtype != np.float32:
        data = data.astype(np.float32)
    if remove_pedestal and "PEDESTAL" in header:
        # MaximDL convention (reference core/ApCalibrate.py:316-326): the
        # PEDESTAL keyword holds the value to ADD to the data to remove
        # the pedestal offset.
        pedestal = float(header["PEDESTAL"])
        if pedestal != 0:
            data = data + np.float32(pedestal)
            del header["PEDESTAL"]
            header.add_history(f"Removed PEDESTAL of {pedestal} ADU from data")
    return data, header


def write_image(
    path: str,
    data: np.ndarray,
    header: Optional[Header] = None,
    overwrite: bool = True,
) -> None:
    """Write a single-image FITS file."""
    hdu = ImageHDU(np.asarray(data), header.copy() if header is not None else Header())
    HDUList([hdu]).writeto(path, overwrite=overwrite)
