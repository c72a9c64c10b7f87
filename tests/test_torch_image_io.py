"""The port's PNG reader and writer (`monogs_dev_tpu_torch/data/image_io.py`)
against PIL, which the JAX package's loaders and fixture writers use.

Both unfilters, the C function (`csrc/png_unfilter.c`, built with the host
C compiler) and its plain numpy/Python version, must decode every file equal
to PIL, sample for sample: random images of each supported mode (8-bit
gray, RGB, RGBA, 16-bit gray) written with every row forced to one of the
five filter types and with the types mixed row by row, and every PNG of the
committed `tests/fixtures/tum_surface`. The writer filters every row with
Paeth. Writing then reading gives the array back exactly, and PIL reads what
the port writes. Unsupported modes raise,
naming the mode; JPEG decodes through the port's decoder with PIL masked
(tests/test_torch_jpeg.py holds it to PIL); a failed build of the C
function raises (no fallback to the plain version)."""

import glob
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from monogs_dev_tpu_torch.data import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_PNGS = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "tum_surface", "*",
                                             "*.png")))
UNFILTERS = {"c": image_io.unfilter_c, "plain": image_io.unfilter_plain}
MODES = {"gray8": (np.uint8, ()), "rgb8": (np.uint8, (3,)), "rgba8": (np.uint8, (4,)),
         "gray16": (np.uint16, ())}


def _filter_row(ftype, cur, prev, bpp):
    """PNG's forward filter of one row (ints 0..255)."""
    out = []
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 255)
    return out


def _png_with_filters(arr, types):
    """A PNG of `arr` whose row y uses filter types[y % len(types)]."""
    color = {1: 0, 3: 2, 4: 6}[1 if arr.ndim == 2 else arr.shape[2]]
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = (arr.astype(">u2").view(np.uint8) if depth == 16 else arr).reshape(arr.shape[0], -1)
    bpp = (1 if arr.ndim == 2 else arr.shape[2]) * depth // 8
    raw, prev = bytearray(), [0] * rows.shape[1]
    for y, row in enumerate(rows.tolist()):
        ftype = types[y % len(types)]
        raw.append(ftype)
        raw.extend(_filter_row(ftype, row, prev, bpp))
        prev = row
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth, color, 0, 0, 0)
    return (image_io.SIGNATURE + image_io._chunk(b"IHDR", ihdr)
            + image_io._chunk(b"IDAT", zlib.compress(bytes(raw))) + image_io._chunk(b"IEND", b""))


def _random(mode, seed, h=13, w=17):
    dtype, extra = MODES[mode]
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max + 1, (h, w) + extra, dtype=dtype)


@pytest.mark.parametrize("impl", sorted(UNFILTERS))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_unfilter_decodes_like_pil(mode, filters, impl, tmp_path):
    arr = _random(mode, seed=10 * sorted(MODES).index(mode) + len(filters) + filters[0])
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(arr, filters))
    ref = np.array(Image.open(path))
    out = image_io.read_png(path, UNFILTERS[impl])
    assert ref.dtype == out.dtype and ref.shape == out.shape
    assert np.array_equal(out, ref) and np.array_equal(out, arr)


@pytest.mark.parametrize("impl", sorted(UNFILTERS))
def test_fixture_files_decode_like_pil(impl):
    assert len(FIXTURE_PNGS) == 160
    for path in FIXTURE_PNGS:
        ref = np.array(Image.open(path))
        out = image_io.read_png(path, UNFILTERS[impl])
        assert out.dtype == ref.dtype and np.array_equal(out, ref), path


def test_fixture_uses_paeth_rows():
    """The committed frames exercise the filters that cost: Paeth rows."""
    info, raw = image_io.parse_png(open(FIXTURE_PNGS[-1], "rb").read())
    types = np.frombuffer(raw, np.uint8).reshape(info.height, -1)[:, 0]
    assert (types == 4).sum() > info.height // 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_write_then_read_is_exact(mode, tmp_path):
    arr = _random(mode, seed=7, h=31, w=23)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, arr)
    assert np.array_equal(image_io.read_png(path), arr)
    assert np.array_equal(image_io.read_png(path, image_io.unfilter_plain), arr)
    assert np.array_equal(np.array(Image.open(path)), arr)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_writer_filters_every_row_with_paeth(mode):
    """The writer's rows are Paeth-filtered, byte for byte as PNG defines
    the filter, so the port's sequences exercise the reader's costly branch."""
    arr = _random(mode, seed=8, h=19, w=11)
    info, raw = image_io.parse_png(image_io.encode_png(arr))
    rows = np.frombuffer(raw, np.uint8).reshape(info.height, -1)
    assert (rows[:, 0] == 4).all()
    plain = (arr.astype(">u2").view(np.uint8) if arr.dtype == np.uint16 else arr)
    plain = plain.reshape(info.height, -1).tolist()
    bpp = info.channels * info.sample_bytes
    prev = [0] * info.stride
    for y, row in enumerate(plain):
        assert rows[y, 1:].tolist() == _filter_row(4, row, prev, bpp), y
        prev = row


@pytest.mark.parametrize("pil_mode,name", [("P", "palette"), ("LA", r"gray\+alpha"),
                                           ("1", "1-bit gray")])
def test_unsupported_modes_raise(pil_mode, name, tmp_path):
    path = str(tmp_path / "x.png")
    Image.new(pil_mode, (8, 6)).save(path)
    with pytest.raises(ValueError, match=name):
        image_io.read_png(path)


def test_interlaced_raises():
    data = bytearray(image_io.encode_png(_random("rgb8", 1)))
    data[8 + 8 + 12] = 1  # IHDR's interlace byte (the CRC is not checked)
    with pytest.raises(ValueError, match="interlaced PNG"):
        image_io.decode_png(bytes(data))


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_jpeg_through_pil_and_raises_without_it(mode, tmp_path, monkeypatch):
    """(Name kept from when JPEG went through PIL.) A PIL-written JPEG of each
    mode decodes, with PIL masked in sys.modules, to what PIL decodes, and
    is told from a PNG by its first bytes."""
    arr = _random("gray8" if mode == "gray" else "rgb8", 2, 16, 24)
    path = str(tmp_path / "x.jpg")
    kw = {} if mode == "gray" else {"subsampling": {"444": 0, "422": 1, "420": 2}[mode]}
    Image.fromarray(arr).save(path, "JPEG", **kw)
    ref = np.array(Image.open(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert np.array_equal(image_io.read_jpeg(path), ref)
    with open(path, "rb") as f:
        assert image_io.image_format(f.read()) == "jpeg"
    assert image_io.image_format(image_io.encode_png(arr)) == "png"
    with pytest.raises(ImportError):
        import PIL  # noqa: F401


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "png_unfilter.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(image_io, "SOURCE", str(bad))
    monkeypatch.setattr(image_io, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(image_io, "_lib", None)
    with pytest.raises(RuntimeError, match="compiler failed"):
        image_io.unfilter_c(b"\0" * 4, np.empty((1, 3), np.uint8), 1, 3, 3)
