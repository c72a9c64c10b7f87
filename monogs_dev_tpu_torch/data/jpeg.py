"""Baseline JPEG decode and encode without PIL (Replica's colour frames,
replay directories of JPEG frames; the JAX package reads them with
`PIL.Image.open`, `monogs_dev_tpu/data/datasets.py:28,210`).

Decoding has three stages:
- `parse`: the markers (SOI, DQT, SOF0/SOF1, DHT, DRI, SOS, EOI; APPn and
  COM skipped) of a baseline 8-bit Huffman file, gray or YCbCr at 4:4:4,
  4:2:2 or 4:2:0. Progressive, arithmetic-coded, lossless, hierarchical,
  12-bit, 2- and 4-component and RGB-colour-space files and other samplings
  raise ValueError naming the mode.
- entropy decoding on the host, into quantised coefficients (int16, 64 a
  block in natural order, every component in one buffer): `decode_scan_c`,
  `csrc/jpeg_entropy.c` built with the host C compiler at first use into
  `build/` and called through ctypes (a failed build raises), or its plain
  version `decode_scan_plain`, for the tests. Corrupt or truncated data
  raises ValueError; the C function checks every read and write.
- `reconstruct`, on the coefficients' device in torch integer ops, with
  libjpeg-turbo's arithmetic (PIL's decoder, with its defaults): the
  dequantisation, the JDCT_ISLOW inverse DCT (jidctint.c's two passes,
  descale and range limit), the fancy (triangular) chroma upsampling
  (jdsample.c, h2v1 and h2v2, box upsampling below 3 chroma columns), and
  the fixed-point YCbCr -> RGB conversion (jdcolor.c). The target is PIL's
  output bit for bit (tests/test_torch_jpeg.py states what it reaches).

`encode_jpeg` writes baseline files: the Annex K Huffman tables, the Annex
K quantisers scaled by quality as libjpeg scales them, 4:2:0 for colour.
It is plain numpy, for the fixture writers.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import image_io

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jpeg_entropy.c")
SOI = b"\xff\xd8"

# csrc/jpeg_entropy.c's error codes
ERRORS = {-1: "no Huffman code matches", -2: "the scan's data ended early (truncated or a "
          "marker)", -3: "a coefficient index past 63", -4: "a missing restart marker",
          -5: "a block outside the coefficient buffer", -6: "a missing or malformed Huffman "
          "table"}

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# ITU T.81 Annex K: the quantisers (K.1, K.2) and Huffman tables (K.3-K.6)
# in file order (the quantisers in zigzag order)
STD_QUANT_ZZ = (
    [16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24, 49,
     35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56,
     80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103,
     99],
    [17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66] + [99] * 50,
)
STD_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
STD_DC_VALS = (list(range(12)), list(range(12)))
STD_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
               [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
STD_AC_VALS = (
    bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
        "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa"),
    bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
        "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa"),
)

# the SOF markers that this decoder refuses, by the mode they name
UNSUPPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
                   0xC6: "differential progressive", 0xC7: "differential lossless",
                   0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
                   0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential "
                   "sequential", 0xCE: "arithmetic-coded differential progressive",
                   0xCF: "arithmetic-coded differential lossless"}


@dataclass
class Component:
    ident: int
    h: int
    v: int
    tq: int
    bw: int = 0        # coefficient blocks a row (the MCU grid's)
    bh: int = 0        # block rows
    off: int = 0       # first block in the shared buffer
    width: int = 0     # samples of the component (libjpeg's downsampled width)
    height: int = 0


@dataclass
class Scan:
    comps: List[int]   # component indices
    dc: List[int]
    ac: List[int]
    start: int         # offset of the entropy-coded data
    restart: int


@dataclass
class JpegInfo:
    width: int
    height: int
    comps: List[Component]
    quant: np.ndarray   # (4, 64) int32, natural order
    scans: List[Scan]
    # the Huffman tables in force at each scan: bits (8, 16) uint8 (DC slots
    # 0-3, AC slots 4-7), vals (8, 256) uint8, present (8,) int32
    tables_at_scan: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    mcus_x: int = 0
    mcus_y: int = 0

    @property
    def n_blocks(self) -> int:
        return sum(c.bw * c.bh for c in self.comps)

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.comps)


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise ValueError("truncated JPEG marker segment")
    return (data[pos] << 8) | data[pos + 1]


def _segment(data: bytes, pos: int) -> Tuple[bytes, int]:
    """(the body of the marker segment whose length field is at pos, the
    offset after it)."""
    length = _u16(data, pos)
    if length < 2 or pos + length > len(data):
        raise ValueError("truncated JPEG marker segment")
    return data[pos + 2:pos + length], pos + length


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """(marker code, offset after it) of the first marker at or after pos,
    past any fill bytes and garbage."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            raise ValueError("JPEG data ends without an EOI marker")
        if data[pos + 1] not in (0x00, 0xFF):
            return data[pos + 1], pos + 2
        pos += 1


def parse(data: bytes) -> JpegInfo:
    """The file's frame, tables and scans (each scan's data offset, with
    the Huffman tables in force at it); raises ValueError on what this
    decoder does not decode."""
    if data[:2] != SOI:
        raise ValueError("not a JPEG file")
    quant = np.zeros((4, 64), np.int32)
    quant_set = [False] * 4
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.int32)
    comps: List[Component] = []
    scans: List[Scan] = []
    tables: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    restart, jfif, adobe, frame = 0, False, None, None
    pos = 2
    while True:
        marker, pos = _next_marker(data, pos)
        if marker == 0xD9:  # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue  # no segment
        body, end = _segment(data, pos)
        if marker in UNSUPPORTED_SOF or marker == 0xCC:
            mode = UNSUPPORTED_SOF.get(marker, "arithmetic-coded (DAC)")
            raise ValueError(f"{mode} JPEG is not supported: baseline Huffman only")
        if marker in (0xC0, 0xC1):
            if frame is not None:
                raise ValueError("JPEG with more than one frame")
            if len(body) < 6:
                raise ValueError("truncated JPEG frame header")
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG is not supported: 8-bit only")
            if nf not in (1, 3):
                raise ValueError(f"{nf}-component JPEG is not supported: 1 (gray) or 3")
            if len(body) < 6 + 3 * nf or width == 0 or height == 0:
                raise ValueError("malformed JPEG frame header")
            for i in range(nf):
                ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4 and tq < 4):
                    raise ValueError("malformed JPEG component")
                comps.append(Component(ident, h, v, tq))
            frame = (width, height)
        elif marker == 0xDB:  # DQT
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or q + 1 + size > len(body):
                    raise ValueError("malformed JPEG quantisation table")
                raw = np.frombuffer(body[q + 1:q + 1 + size], ">u2" if pq else np.uint8)
                quant[tq, ZIGZAG] = raw.astype(np.int32)
                quant_set[tq] = True
                q += 1 + size
        elif marker == 0xC4:  # DHT
            q = 0
            while q < len(body):
                if q + 17 > len(body):
                    raise ValueError("malformed JPEG Huffman table")
                tc, th = body[q] >> 4, body[q] & 15
                counts = np.frombuffer(body[q + 1:q + 17], np.uint8)
                n = int(counts.sum())
                if tc > 1 or th > 3 or n > 256 or q + 17 + n > len(body):
                    raise ValueError("malformed JPEG Huffman table")
                slot = 4 * tc + th
                bits[slot] = counts
                vals[slot] = 0
                vals[slot, :n] = np.frombuffer(body[q + 17:q + 17 + n], np.uint8)
                present[slot] = 1
                q += 17 + n
        elif marker == 0xDD:  # DRI
            if len(body) < 2:
                raise ValueError("malformed JPEG restart interval")
            restart = _u16(body, 0)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before the frame header")
            ns = body[0] if body else 0
            if not 1 <= ns <= len(comps) or len(body) < 4 + 2 * ns:
                raise ValueError("malformed JPEG scan header")
            idx, dc, ac = [], [], []
            for i in range(ns):
                cid, sel = body[1 + 2 * i], body[2 + 2 * i]
                match = [k for k, c in enumerate(comps) if c.ident == cid]
                if not match or match[0] in idx:
                    raise ValueError("JPEG scan names an unknown component")
                idx.append(match[0])
                dc.append(sel >> 4)
                ac.append(sel & 15)
                if dc[-1] > 3 or ac[-1] > 3:
                    raise ValueError("malformed JPEG scan header")
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise ValueError("JPEG scan with spectral selection or successive "
                                 "approximation (progressive) is not supported")
            scans.append(Scan(idx, dc, ac, end, restart))
            tables.append((bits.copy(), vals.copy(), present.copy()))
            # the scan's data runs to the next marker that is not RSTn
            pos = end
            while True:
                marker, after = _next_marker(data, pos)
                if 0xD0 <= marker <= 0xD7:
                    pos = after
                    continue
                pos = after - 2
                break
            continue
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        pos = end
    if frame is None:
        raise ValueError("JPEG without a frame header (SOF0/SOF1)")
    if not scans:
        raise ValueError("JPEG without a scan")
    for c in comps:
        if not quant_set[c.tq]:
            raise ValueError("JPEG component without its quantisation table")
    width, height = frame
    info = JpegInfo(width, height, comps, quant, scans, tables)
    _check_sampling(info)
    # libjpeg's default_decompress_parms: three components are YCbCr unless
    # an Adobe marker (transform 0) or the ids 'R', 'G', 'B' say RGB
    if len(comps) == 3 and not jfif and (
            adobe == 0 or (adobe is None and [c.ident for c in comps] == [82, 71, 66])):
        raise ValueError("RGB-colour-space JPEG is not supported: gray or YCbCr only")
    _geometry(info)
    return info


def _check_sampling(info: JpegInfo) -> None:
    comps = info.comps
    if len(comps) == 1:
        return
    hmax, vmax = info.hmax, info.vmax
    ratios = [(hmax // c.h, vmax // c.v) if hmax % c.h == 0 and vmax % c.v == 0 else None
              for c in comps]
    ok = {(1, 1), (2, 1), (2, 2)}
    if ratios[0] != (1, 1) or any(r not in ok for r in ratios) or ratios[1] != ratios[2]:
        names = ",".join(f"{c.h}x{c.v}" for c in comps)
        raise ValueError(f"JPEG chroma sampling {names} is not supported: 4:4:4, 4:2:2 "
                         "or 4:2:0")


def _geometry(info: JpegInfo) -> None:
    """The MCU grid, each component's sample size and its blocks in the
    shared coefficient buffer (the MCU grid padded; a single component's
    grid is its own blocks, as libjpeg's)."""
    hmax, vmax = info.hmax, info.vmax
    if len(info.comps) == 1:
        c = info.comps[0]
        c.width, c.height = info.width, info.height
        c.bw, c.bh = -(-info.width // 8), -(-info.height // 8)
        info.mcus_x, info.mcus_y = c.bw, c.bh
        return
    info.mcus_x = -(-info.width // (8 * hmax))
    info.mcus_y = -(-info.height // (8 * vmax))
    off = 0
    for c in info.comps:
        c.width = -(-info.width * c.h // hmax)
        c.height = -(-info.height * c.v // vmax)
        c.bw, c.bh, c.off = info.mcus_x * c.h, info.mcus_y * c.v, off
        off += c.bw * c.bh


def _scan_grid(info: JpegInfo, scan: Scan) -> Tuple[int, int]:
    """MCUs across and down: the frame's for an interleaved scan, the
    component's blocks for a scan of one (T.81 A.2.2)."""
    if len(scan.comps) > 1:
        return info.mcus_x, info.mcus_y
    c = info.comps[scan.comps[0]]
    return -(-c.width // 8), -(-c.height // 8)


# ------------------------------------------------------------------ entropy decoding


_lib = None
_lib_lock = threading.Lock()


def build() -> Tuple[str, float]:
    """Compile `csrc/jpeg_entropy.c`; (library path, seconds; 0.0 if built)."""
    return image_io.compile_c(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            ip = ctypes.POINTER(ctypes.c_int)
            lib.jpeg_decode_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ip, ip, ip, ip, ip, ip, ip, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ip, ctypes.c_void_p, ctypes.c_longlong]
            lib.jpeg_decode_scan.restype = ctypes.c_int
            _lib = lib
    return _lib


def _raise(rc: int, scan_no: int) -> None:
    raise ValueError(f"corrupt JPEG data in scan {scan_no}: {ERRORS.get(rc, rc)}")


class _Corrupt(Exception):
    """The plain decoder's failure, with the C function's error code."""

    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


def decode_scan_c(data: bytes, info: JpegInfo, k: int, coef: np.ndarray) -> None:
    """Entropy-decode scan k of `data` into `coef` ((n_blocks, 64) int16,
    C-contiguous) with the C function."""
    if not (coef.dtype == np.int16 and coef.flags.c_contiguous and coef.flags.writeable
            and coef.shape == (info.n_blocks, 64)):
        raise ValueError("coef must be a writeable C-contiguous (n_blocks, 64) int16 array")
    scan = info.scans[k]
    bits, vals, present = info.tables_at_scan[k]
    comps = [info.comps[i] for i in scan.comps]

    def ints(xs):
        return (ctypes.c_int * 4)(*xs)

    mx, my = _scan_grid(info, scan)
    bits = np.ascontiguousarray(bits)
    vals = np.ascontiguousarray(vals)
    rc = _load().jpeg_decode_scan(
        data, len(data), scan.start, len(comps), ints([c.h for c in comps]),
        ints([c.v for c in comps]), ints([c.bw for c in comps]), ints([c.bh for c in comps]),
        ints([c.off for c in comps]), ints(scan.dc), ints(scan.ac), mx, my, scan.restart,
        bits.ctypes.data, vals.ctypes.data, (ctypes.c_int * 8)(*[int(p) for p in present]),
        coef.ctypes.data, coef.shape[0])
    if rc < 0:
        _raise(rc, k)


class _Table:
    """A Huffman table for the plain decoder (T.81 F.2.2.3's MAXCODE,
    VALPTR and MINCODE), with libjpeg's checks."""

    def __init__(self, bits: np.ndarray, vals: np.ndarray):
        total = int(bits.sum())
        if total > 256:
            raise _Corrupt(-6)
        self.vals = [int(v) for v in vals[:total]]
        self.maxcode, self.valoff = [-1] * 18, [0] * 17
        code, k = 0, 0
        for l in range(1, 17):
            n = int(bits[l - 1])
            if n:
                self.valoff[l] = k - code
                code += n
                k += n
                self.maxcode[l] = code - 1
            if code >= (1 << l):
                raise _Corrupt(-6)
            code <<= 1


class _Bits:
    """The plain decoder's bit reader: stuffed bytes undone, stops at a
    marker or the data's end (reading past it raises)."""

    def __init__(self, data: bytes, pos: int):
        self.d, self.pos, self.buf, self.n, self.ended = data, pos, 0, 0, False

    def _byte(self) -> bool:
        d = self.d
        while not self.ended:
            if self.pos >= len(d):
                self.ended = True
                break
            b = d[self.pos]
            if b != 0xFF:
                self.pos += 1
                self.buf, self.n = (self.buf << 8) | b, self.n + 8
                return True
            if self.pos + 1 >= len(d):
                self.ended = True
                break
            nxt = d[self.pos + 1]
            if nxt == 0x00:
                self.pos += 2
                self.buf, self.n = (self.buf << 8) | 0xFF, self.n + 8
                return True
            if nxt == 0xFF:
                self.pos += 1
                continue
            self.ended = True
        return False

    def bit(self) -> int:
        if self.n == 0 and not self._byte():
            raise _Corrupt(-2)
        self.n -= 1
        return (self.buf >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def symbol(self, t: _Table) -> int:
        code, l = self.bit(), 1
        while code > t.maxcode[l]:
            l += 1
            if l > 16:
                raise _Corrupt(-1)
            code = (code << 1) | self.bit()
        idx = code + t.valoff[l]
        if not 0 <= idx < len(t.vals):
            raise _Corrupt(-1)
        return t.vals[idx]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def decode_scan_plain(data: bytes, info: JpegInfo, k: int, coef: np.ndarray) -> None:
    """`decode_scan_c` in Python (T.81 F.2.2, bit by bit)."""
    scan = info.scans[k]
    bits, vals, present = info.tables_at_scan[k]
    comps = [info.comps[i] for i in scan.comps]
    try:
        tables = {}
        for sel in [d for d in scan.dc] + [4 + a for a in scan.ac]:
            if not present[sel]:
                raise _Corrupt(-6)
            tables[sel] = _Table(bits[sel], vals[sel])
        mx, my = _scan_grid(info, scan)
        r = _Bits(data, scan.start)
        pred = [0] * len(comps)
        ns = len(comps)
        for m in range(mx * my):
            if scan.restart and m and m % scan.restart == 0:
                r.n = 0
                while r._byte():  # only padding may be left before the marker
                    raise _Corrupt(-4)
                rst = (m // scan.restart - 1) & 7
                if r.pos + 1 >= len(data) or data[r.pos] != 0xFF or data[r.pos + 1] != 0xD0 + rst:
                    raise _Corrupt(-4)
                r = _Bits(data, r.pos + 2)
                pred = [0] * ns
            for ci, c in enumerate(comps):
                hh, vv = (c.h, c.v) if ns > 1 else (1, 1)
                dc, ac = tables[scan.dc[ci]], tables[4 + scan.ac[ci]]
                for by in range(vv):
                    for bx in range(hh):
                        row, col = (m // mx) * vv + by, (m % mx) * hh + bx
                        if row >= c.bh or col >= c.bw:
                            raise _Corrupt(-5)
                        blk = coef[c.off + row * c.bw + col]
                        blk[:] = 0
                        s = r.symbol(dc)
                        if s > 15:
                            raise _Corrupt(-1)
                        diff = _extend(r.bits(s), s) if s else 0
                        pred[ci] = (pred[ci] + diff + 2 ** 31) % 2 ** 32 - 2 ** 31
                        blk[0] = np.int32(pred[ci]).astype(np.int16)
                        i = 1
                        while i < 64:
                            rs = r.symbol(ac)
                            run, size = rs >> 4, rs & 15
                            if size:
                                i += run
                                if i > 63:
                                    raise _Corrupt(-3)
                                blk[ZIGZAG[i]] = np.int32(_extend(r.bits(size), size)).astype(
                                    np.int16)
                                i += 1
                            elif run == 15:
                                i += 16
                            else:
                                break
    except _Corrupt as e:
        _raise(e.code, k)


def decode_coefficients(data: bytes, alloc: Optional[Callable] = None,
                        entropy: Optional[Callable] = None) -> Tuple[JpegInfo, np.ndarray]:
    """(info, buffer (4 + n_blocks, 64) int16): rows 0-3 the quantisation
    tables (natural order, their 16-bit patterns), then the quantised
    coefficients, so that one copy takes all the device stage needs.
    `alloc(shape)` gives the buffer (e.g. a view of pinned host memory);
    `entropy` is the scan decoder, by default the C function."""
    info = parse(data)
    shape = (4 + info.n_blocks, 64)
    buf = np.empty(shape, np.int16) if alloc is None else alloc(shape)
    buf[:4] = info.quant.astype(np.uint16).view(np.int16)
    coef = buf[4:]
    coef.fill(0)  # blocks no scan reaches (padding of a single-component scan)
    for k in range(len(info.scans)):
        (entropy or decode_scan_c)(data, info, k, coef)
    return info, buf


# ------------------------------------------------------------------ the device stage

CONST_BITS, PASS1_BITS = 13, 2
FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
       "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
       "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x: List[torch.Tensor], shift0: int, descale: int) -> List[torch.Tensor]:
    """jidctint.c's one-dimensional pass on int64 tensors: x[0..7] the
    inputs, `shift0` the left shift of the even part's DC terms
    (CONST_BITS), outputs descaled (rounded right shift) by `descale`."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX["0_541196100"]
    tmp2 = z1 + z3 * -FIX["1_847759065"]
    tmp3 = z1 + z2 * FIX["0_765366865"]
    tmp0 = (x[0] + x[4]) << shift0
    tmp1 = (x[0] - x[4]) << shift0
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX["1_175875602"]
    t0 = t0 * FIX["0_298631336"]
    t1 = t1 * FIX["2_053119869"]
    t2 = t2 * FIX["3_072711026"]
    t3 = t3 * FIX["1_501321110"]
    z1 = z1 * -FIX["0_899976223"]
    z2 = z2 * -FIX["2_562915447"]
    z3 = z3 * -FIX["1_961570560"] + z5
    z4 = z4 * -FIX["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (descale - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1,
           tmp11 - t2, tmp10 - t3]
    return [(o + r) >> descale for o in out]


def idct_islow(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Dequantise and inverse-transform blocks as libjpeg's JDCT_ISLOW:
    coef (N, 64) int16 natural order, quant (64,) or (N, 64) int32 ->
    (N, 8, 8) uint8 samples (level shift and range limit applied)."""
    x = (coef.to(torch.int32) * quant.to(torch.int32)).to(torch.int64).view(-1, 8, 8)
    # pass 1: columns (inputs along the rows), into an int workspace
    ws = _idct_1d([x[:, k, :] for k in range(8)], CONST_BITS, CONST_BITS - PASS1_BITS)
    ws = torch.stack(ws, dim=1).to(torch.int32).to(torch.int64)
    # pass 2: rows of the workspace
    out = _idct_1d([ws[:, :, k] for k in range(8)], CONST_BITS, CONST_BITS + PASS1_BITS + 3)
    v = torch.stack(out, dim=2)
    # the range-limit table's index (& RANGE_MASK) read as a signed 10-bit value
    v = ((v & 1023) ^ 512) - 512
    return (v + 128).clamp(0, 255).to(torch.uint8)


def _fancy_h2(cols: torch.Tensor, width: int, bias_even: int, bias_odd: int,
              shift: int) -> torch.Tensor:
    """Horizontal triangle upsampling of (..., W) int32 values (`width`
    valid columns) to (..., 2 * width), as jdsample.c: even outputs
    (3 x + left + bias_even) >> shift, odd outputs (3 x + right + bias_odd)
    >> shift, the first and the last output (4 x + bias) >> shift."""
    x = cols[..., :width]
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = (3 * x + left + bias_even) >> shift
    odd = (3 * x + right + bias_odd) >> shift
    even[..., 0] = (4 * x[..., 0] + bias_even) >> shift
    odd[..., -1] = (4 * x[..., -1] + bias_odd) >> shift
    return torch.stack([even, odd], dim=-1).flatten(-2)


def upsample(plane: torch.Tensor, c: Component, hmax: int, vmax: int) -> torch.Tensor:
    """A chroma plane (bh*8, bw*8) uint8 -> (full height, full width)
    int32, as libjpeg-turbo's upsampler with fancy upsampling on."""
    w, h = c.width, c.height
    x = plane[:h, :].to(torch.int32)
    ratio = (hmax // c.h, vmax // c.v)
    if ratio == (1, 1):
        return x[:, :w]
    if w <= 2:  # jdsample.c: box upsampling below 3 columns
        x = x[:, :w].repeat_interleave(ratio[0], dim=1)
        return x.repeat_interleave(ratio[1], dim=0)
    if ratio == (2, 1):  # h2v1_fancy_upsample
        return _fancy_h2(x, w, 1, 2, 2)
    # h2v2_fancy_upsample: column sums with the nearer row (the first and
    # last rows stand in for their missing neighbours), then horizontally
    up = torch.cat([x[:1], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[-1:]], dim=0)
    top = _fancy_h2(3 * x + up, w, 8, 7, 4)
    bottom = _fancy_h2(3 * x + down, w, 8, 7, 4)
    return torch.stack([top, bottom], dim=1).flatten(0, 1)


# jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16)
def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """int32 planes -> (H, W, 3) uint8, with jdcolor.c's tables."""
    half = 1 << 15
    cb64, cr64 = cb.to(torch.int64) - 128, cr.to(torch.int64) - 128
    r_cr = (_fix(1.40200) * cr64 + half) >> 16
    b_cb = (_fix(1.77200) * cb64 + half) >> 16
    g = (-_fix(0.34414) * cb64 + half + -_fix(0.71414) * cr64) >> 16
    y64 = y.to(torch.int64)
    rgb = torch.stack([y64 + r_cr, y64 + g, y64 + b_cb], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def reconstruct(info: JpegInfo, buf: torch.Tensor) -> torch.Tensor:
    """The device stage: `decode_coefficients`'s buffer on any device -> the
    image on that device, uint8 (H, W) for one component, (H, W, 3)
    otherwise. It reads nothing from the host."""
    quant = buf[:4].to(torch.int32) & 0xFFFF
    coef = buf[4:]
    planes = []
    for c in info.comps:
        blocks = idct_islow(coef[c.off:c.off + c.bw * c.bh], quant[c.tq])
        plane = blocks.view(c.bh, c.bw, 8, 8).permute(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(plane)
    if len(info.comps) == 1:
        c = info.comps[0]
        return planes[0][:c.height, :c.width].contiguous()
    full = [upsample(p, c, info.hmax, info.vmax)[:info.height, :info.width]
            for p, c in zip(planes, info.comps)]
    return ycc_to_rgb(*full)


def decode(data: bytes, device="cpu", entropy: Optional[Callable] = None) -> torch.Tensor:
    """JPEG bytes -> uint8 (H, W) or (H, W, 3) tensor on `device`."""
    info, buf = decode_coefficients(data, entropy=entropy)
    return reconstruct(info, torch.from_numpy(buf).to(device))


# ------------------------------------------------------------------ encode


def scaled_quant(quality: int) -> np.ndarray:
    """(2, 64) Annex K quantisers in natural order at `quality` (1..100),
    as libjpeg's jpeg_quality_scaling with baseline limits."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = np.zeros((2, 64), np.int64)
    for t in range(2):
        base = np.zeros(64, np.int64)
        base[ZIGZAG] = STD_QUANT_ZZ[t]
        out[t] = np.clip((base * scale + 50) // 100, 1, 255)
    return out


def _codes(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol 0..255 of a Huffman table."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for l in range(1, 17):
        for _ in range(bits[l - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, l
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _plane_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(H, W) -> (bh, bw, 8, 8), the edges replicated to bh*8 x bw*8."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def encode_jpeg(arr: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> baseline JFIF bytes (gray, or YCbCr at
    4:2:0), one interleaved scan, the Annex K Huffman tables."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"cannot write a JPEG from {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"cannot write a JPEG of {w}x{h}")
    quant = scaled_quant(quality)
    if arr.ndim == 2:
        comps = [(1, 1, 0, arr.astype(np.float64))]
        hmax = vmax = 1
    else:
        rgb = arr.astype(np.int64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        half = 1 << 15  # jccolor.c's FIX() weights, SCALEBITS 16
        y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
        cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + half - 1) >> 16
        cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + half - 1) >> 16

        def down(p):  # 2x2 box average, the edges replicated to even sizes
            p = np.pad(p, ((0, h % 2), (0, w % 2)), mode="edge")
            return (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2] + 2) >> 2

        comps = [(2, 2, 0, y), (1, 1, 1, down(cb)), (1, 1, 1, down(cr))]
        hmax = vmax = 2
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    # quantised coefficients of each component, (bh, bw, 64) zigzag order
    zz = []
    for ch, cv, tq, plane in comps:
        blocks = _plane_blocks(plane.astype(np.float64) - 128.0, mcus_y * cv, mcus_x * ch)
        f = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT).reshape(*blocks.shape[:2], 64)
        qv = f / quant[tq]
        q = (np.sign(qv) * np.floor(np.abs(qv) + 0.5)).astype(np.int64)
        zz.append(q[..., ZIGZAG])
    # blocks in scan order (MCU by MCU, each component's h x v blocks)
    order_blocks, order_comp = [], []
    for ci, (ch, cv, _, _) in enumerate(comps):
        bh, bw = mcus_y * cv, mcus_x * ch
        z = zz[ci].reshape(mcus_y, cv, mcus_x, ch, 64).transpose(0, 2, 1, 3, 4)
        order_blocks.append(z.reshape(mcus_y * mcus_x, cv * ch, 64))
        order_comp.append(np.full((mcus_y * mcus_x, cv * ch), ci))
    blocks = np.concatenate(order_blocks, axis=1).reshape(-1, 64)
    comp = np.concatenate(order_comp, axis=1).reshape(-1)
    nb = blocks.shape[0]
    tables = {t: (_codes(STD_DC_BITS[t], STD_DC_VALS[t]), _codes(STD_AC_BITS[t], STD_AC_VALS[t]))
              for t in (0, 1)}
    tsel = np.array([c[2] for c in comps])[comp]

    def size_of(v):
        a = np.abs(v)
        s = np.zeros_like(a)
        nz = a > 0
        s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        return s

    def mag_bits(v, s):
        return np.where(v >= 0, v, v - 1) & ((1 << s) - 1)

    # DC: differences within each component
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for ci in range(len(comps)):
        sel = np.nonzero(comp == ci)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    s = size_of(diff)
    dc_code = np.where(tsel == 0, tables[0][0][0][s], tables[1][0][0][s])
    dc_len = np.where(tsel == 0, tables[0][0][1][s], tables[1][0][1][s])
    ev_block = [np.arange(nb)]
    ev_k = [np.zeros(nb, np.int64)]
    ev_sub = [np.zeros(nb, np.int64)]
    ev_val = [(dc_code << s) | mag_bits(diff, s)]
    ev_len = [dc_len + s]
    # AC: each nonzero coefficient, after its ZRLs
    b, kk = np.nonzero(blocks[:, 1:])
    kk = kk + 1
    prev = np.zeros_like(kk)
    same = np.concatenate([[False], b[1:] == b[:-1]])
    prev[same] = kk[:-1][same[1:]]
    run = kk - prev - 1
    v = blocks[b, kk]
    s = size_of(v)
    t = tsel[b]
    sym = ((run % 16) << 4) | s
    code = np.where(t == 0, tables[0][1][0][sym], tables[1][1][0][sym])
    clen = np.where(t == 0, tables[0][1][1][sym], tables[1][1][1][sym])
    ev_block.append(b)
    ev_k.append(kk)
    ev_sub.append(np.full(b.shape, 3))
    ev_val.append((code << s) | mag_bits(v, s))
    ev_len.append(clen + s)
    for j in range(3):  # ZRL (0xF0) before runs of 16 and more
        zr = np.nonzero(run // 16 > j)[0]
        tz = t[zr]
        ev_block.append(b[zr])
        ev_k.append(kk[zr])
        ev_sub.append(np.full(zr.shape, j))
        ev_val.append(np.where(tz == 0, tables[0][1][0][0xF0], tables[1][1][0][0xF0]))
        ev_len.append(np.where(tz == 0, tables[0][1][1][0xF0], tables[1][1][1][0xF0]))
    # EOB where the last coefficient is zero
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, kk)
    eob = np.nonzero(last < 63)[0]
    te = tsel[eob]
    ev_block.append(eob)
    ev_k.append(np.full(eob.shape, 64))
    ev_sub.append(np.zeros(eob.shape, np.int64))
    ev_val.append(np.where(te == 0, tables[0][1][0][0x00], tables[1][1][0][0x00]))
    ev_len.append(np.where(te == 0, tables[0][1][1][0x00], tables[1][1][1][0x00]))
    key = np.lexsort((np.concatenate(ev_sub), np.concatenate(ev_k), np.concatenate(ev_block)))
    val = np.concatenate(ev_val)[key]
    ln = np.concatenate(ev_len)[key]
    # the bit stream, MSB first, padded with ones; 0xFF bytes stuffed
    total = int(ln.sum())
    starts = np.repeat(np.cumsum(ln) - ln, ln)
    pos = np.arange(total) - starts
    bitv = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - pos)) & 1
    bitv = np.concatenate([bitv, np.ones((-total) % 8, np.int64)]).astype(np.uint8)
    payload = np.packbits(bitv)
    ff = np.nonzero(payload == 0xFF)[0]
    payload = np.insert(payload, ff + 1, 0).tobytes()

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [SOI, seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")]
    for t in sorted({c[2] for c in comps}):
        out.append(seg(0xDB, bytes([t]) + bytes(quant[t][ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for ci, (ch, cv, tq, _) in enumerate(comps):
        sof += bytes([ci + 1, (ch << 4) | cv, tq])
    out.append(seg(0xC0, sof))
    for t in sorted({c[2] for c in comps}):
        out.append(seg(0xC4, bytes([t]) + bytes(STD_DC_BITS[t]) + bytes(STD_DC_VALS[t])))
        out.append(seg(0xC4, bytes([0x10 | t]) + bytes(STD_AC_BITS[t]) + STD_AC_VALS[t]))
    sos = bytes([len(comps)])
    for ci, (_, _, tq, _) in enumerate(comps):
        sos += bytes([ci + 1, (tq << 4) | tq])
    out.append(seg(0xDA, sos + bytes([0, 63, 0])))
    out.append(payload)
    out.append(b"\xff\xd9")
    return b"".join(out)
