"""PNG and JPEG decode and encode without PIL or cv2, for the loaders and the fixture
writers (the JAX package reads with `PIL.Image.open` and `cv2.imread`,
`monogs_dev_tpu/data/datasets.py:210,218,307-308`, and writes with
`Image.fromarray(...).save`).

Decoding parses the chunks, inflates the IDAT stream with `zlib` and
reverses the row filters in `csrc/png_unfilter.c`, which is compiled with
the host C compiler at first use into `build/` and called through `ctypes`
(a failed build raises). `unfilter_plain` is its plain numpy/Python
version, for the tests. Supported: non-interlaced 8-bit gray, RGB and RGBA
and 16-bit gray (big-endian samples in the file), the modes of TUM, Replica
and EuRoC; the samples come back as `np.array(PIL.Image.open(path))` gives
them. Encoding writes 8-bit gray, RGB or RGBA and 16-bit gray, with the
Paeth filter on every row: PIL's adaptive choice on nearly every row of a
rendered or camera frame, so the sequences the port writes cost the reader
what real ones do. JPEG (Replica's colour frames) is decoded and encoded by
`data/jpeg.py`; `image_format` tells the two apart by the file's first
bytes, as PIL does, not by its name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import time
import zlib
from typing import Callable, NamedTuple, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "build")
SOURCE = os.path.join(_PKG, "csrc", "png_unfilter.c")
CC_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c99"]
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (channels, bytes per sample)
MODES = {(0, 8): (1, 1), (2, 8): (3, 1), (6, 8): (4, 1), (0, 16): (1, 2)}
COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}

_lib = None
_lib_lock = threading.Lock()


class PngInfo(NamedTuple):
    width: int
    height: int
    channels: int
    sample_bytes: int  # 1 or 2 (16-bit samples, big-endian in the rows)

    @property
    def stride(self) -> int:
        return self.width * self.channels * self.sample_bytes


# ------------------------------------------------------------------ the C unfilter


def _compiler() -> str:
    for name in ("cc", "gcc", "clang"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C compiler (cc, gcc or clang) to build csrc/png_unfilter.c")


def library_path(source: str = None) -> str:
    """`build/lib<source name>_<key>.so`, the key a hash of the flags and
    the source (by default `csrc/png_unfilter.c`)."""
    source = source or SOURCE
    h = hashlib.sha1(" ".join(CC_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def compile_c(source: str) -> Tuple[str, float]:
    """Compile a host C source of the port (`csrc/*.c`) into a shared
    library; (library path, seconds; 0.0 if built). A failure raises."""
    out = library_path(source)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([_compiler(), *CC_FLAGS, "-o", lib, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the C compiler failed on {source}:\n{proc.stderr}")
        os.replace(lib, out)
    return out, time.time() - t0


def build() -> Tuple[str, float]:
    """Compile `csrc/png_unfilter.c`; (library path, seconds; 0.0 if built)."""
    return compile_c(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
    return _lib


def unfilter_c(raw: bytes, out: np.ndarray, height: int, stride: int, bpp: int) -> None:
    """Reverse the row filters of `raw` (height x (1 + stride) bytes) into
    the C-contiguous uint8 array `out` (height x stride bytes)."""
    if not (out.dtype == np.uint8 and out.flags.c_contiguous and out.flags.writeable
            and out.nbytes == height * stride):
        raise ValueError("out must be a writeable C-contiguous uint8 array of height * stride "
                         "bytes")
    if len(raw) < height * (stride + 1) or not 1 <= bpp <= 8:
        raise ValueError("raw must hold height rows of 1 + stride bytes; bpp 1..8")
    rc = _load().png_unfilter(raw, out.ctypes.data, height, stride, bpp)
    if rc < 0:
        raise ValueError(f"PNG row {-rc - 1}: unknown filter type")


def unfilter_plain(raw: bytes, out: np.ndarray, height: int, stride: int, bpp: int) -> None:
    """`unfilter_c` in numpy and Python (None, Sub and Up vectorised;
    Average and Paeth byte by byte)."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    dst = out.reshape(height, stride)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        ftype, cur = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            res = cur
        elif ftype == 1:
            pad = (-stride) % bpp
            c = np.concatenate([cur, np.zeros(pad, np.int64)]).reshape(-1, bpp)
            res = (np.cumsum(c, axis=0) % 256).reshape(-1)[:stride]
        elif ftype == 2:
            res = (cur + prev) % 256
        elif ftype in (3, 4):
            res = [0] * stride
            up = prev.tolist()
            cl = cur.tolist()
            for i in range(stride):
                a = res[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                res[i] = (cl[i] + pred) & 255
            res = np.asarray(res, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type")
        dst[y] = res
        prev = np.asarray(res, np.int64)


# ------------------------------------------------------------------ decode


def parse_png(data: bytes) -> Tuple[PngInfo, bytes]:
    """(header, the inflated IDAT stream); raises on modes the loaders do
    not read (interlaced, palette, gray+alpha, other bit depths)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    mode = f"{depth}-bit {COLOR_NAMES.get(color, f'colour type {color}')}"
    if interlace:
        raise ValueError(f"interlaced PNG ({mode}) is not supported")
    if (color, depth) not in MODES:
        raise ValueError(f"PNG mode {mode} is not supported: 8-bit gray, RGB, RGBA "
                         "and 16-bit gray are")
    channels, sample_bytes = MODES[(color, depth)]
    return PngInfo(width, height, channels, sample_bytes), zlib.decompress(b"".join(idat))


def decode_rows(data: bytes, alloc: Callable = None, unfilter: Callable = None):
    """(header, unfiltered rows (height, stride) uint8). `alloc(shape)`
    gives the destination array (e.g. a view of pinned host memory);
    `unfilter` defaults to the C function."""
    info, raw = parse_png(data)
    shape = (info.height, info.stride)
    if len(raw) < info.height * (info.stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty(shape, np.uint8) if alloc is None else alloc(shape)
    (unfilter or unfilter_c)(raw, out, info.height, info.stride,
                             info.channels * info.sample_bytes)
    return info, out


def samples(info: PngInfo, rows: np.ndarray) -> np.ndarray:
    """Rows -> (H, W) or (H, W, C) samples, uint8 or (16-bit) native uint16."""
    if info.sample_bytes == 2:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    shape = (info.height, info.width) + ((info.channels,) if info.channels > 1 else ())
    return img.reshape(shape)


def decode_png(data: bytes, unfilter: Callable = None) -> np.ndarray:
    return samples(*decode_rows(data, unfilter=unfilter))


def read_png(path: str, unfilter: Callable = None) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), unfilter)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline JPEG file's samples, uint8 (H, W) or (H, W, 3), decoded on
    the CPU by `data/jpeg.py`."""
    from . import jpeg

    with open(path, "rb") as f:
        return jpeg.decode(f.read(), "cpu").numpy()


def image_format(data: bytes) -> str:
    """"png" or "jpeg" from the first bytes; anything else raises."""
    if data[:8] == SIGNATURE:
        return "png"
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    raise ValueError("not a PNG or JPEG file")



# ------------------------------------------------------------------ encode


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _paeth_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG's forward Paeth filter of uint8 rows (H, stride). It reads only
    unfiltered bytes, so the whole image is filtered at once."""
    x = rows.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) / (H, W, 3) / (H, W, 4) or uint16 (H, W) -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        color, depth, rows = 0, 16, arr.astype(">u2").view(np.uint8)
    elif arr.dtype == np.uint8 and (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (3, 4))):
        color = 0 if arr.ndim == 2 else (2 if arr.shape[2] == 3 else 6)
        depth, rows = 8, arr
    else:
        raise ValueError(f"cannot write a PNG from {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    bpp = rows.shape[1] // w
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), _paeth_rows(rows, bpp)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


# the quality of the JPEG files the port writes (Replica's colour frames)
JPEG_QUALITY = 95


def write_jpeg(path: str, arr: np.ndarray) -> None:
    """uint8 (H, W) or (H, W, 3) -> a baseline JPEG file at JPEG_QUALITY
    (4:2:0 for colour; `data/jpeg.py::encode_jpeg`)."""
    from . import jpeg

    with open(path, "wb") as f:
        f.write(jpeg.encode_jpeg(arr, JPEG_QUALITY))
