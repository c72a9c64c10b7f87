"""The port's JPEG decoder and encoder (`monogs_dev_tpu_torch/data/jpeg.py`,
`csrc/jpeg_entropy.c`) against PIL 12.1 with libjpeg-turbo, the JAX
package's reader (`PIL.Image.open`).

- Decode: PIL-written files, gray and RGB at 4:4:4, 4:2:2 and 4:2:0, at
  qualities 50, 75 and 95, with and without restart intervals, at a size
  that is a whole number of MCUs and at odd sizes, through both entropy
  decoders (the C function and its plain Python version). Tolerance: none;
  every sample equals `np.array(PIL.Image.open(...))` (libjpeg-turbo's
  JDCT_ISLOW, fancy upsampling and fixed-point colour conversion,
  reproduced in integer arithmetic). A failure reports the share of
  samples that differ and the largest difference.
- Encode: PIL decodes the port's `encode_jpeg` files to exactly what the
  port decodes, and the round trip stays close to the source.
- Unsupported modes (progressive, arithmetic-coded, lossless, 12-bit,
  4-component, RGB colour space, 4:1:1 sampling) raise ValueError naming
  the mode; corrupt
  and truncated data raise ValueError from both entropy decoders.
- Sanitizers: `csrc/png_unfilter.c` and `csrc/jpeg_entropy.c` compiled
  with `-fsanitize=address,undefined` into a harness that runs a few
  hundred truncated and bit-flipped streams made from a seed, in a
  subprocess, which must exit cleanly: no read or write out of bounds, no
  undefined behaviour.
"""

import io
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
from PIL import Image

from monogs_dev_tpu_torch.data import image_io, jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "monogs_dev_tpu_torch", "csrc")
ENTROPY = {"c": jpeg.decode_scan_c, "plain": jpeg.decode_scan_plain}
SUBSAMPLING = {"gray": None, "444": 0, "422": 1, "420": 2}
SIZES = [(48, 64), (37, 29)]  # whole MCUs; odd sizes with partial blocks and MCUs


def _image(h, w, channels, seed):
    """Noise over smooth gradients, so that every coefficient band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = [(x * 5 + y * 3) % 256, (x * 2 + 128) % 256, (y * 7) % 256][:channels]
    img = np.stack(base, -1) + rng.integers(-40, 40, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pil_jpeg(arr, quality, subsampling=None, **kw):
    buf = io.BytesIO()
    if subsampling is not None:
        kw["subsampling"] = subsampling
    Image.fromarray(arr).save(buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()


def _assert_same(mine, ref):
    assert mine.shape == ref.shape and mine.dtype == ref.dtype == np.uint8
    diff = np.abs(mine.astype(np.int64) - ref.astype(np.int64))
    assert not diff.any(), (f"{(diff > 0).mean():.6f} of the samples differ, the largest "
                            f"by {diff.max()}")


# every mode x quality x restarts x entropy decoder at SIZES, and one case at
# Replica's 1200x680 as its writer makes it (4:2:0, quality 95; the C
# decoder: the plain one takes about a minute a frame)
DECODE_CASES = [pytest.param(m, q, r, e, SIZES, id=f"{m}-{q}-{r}-{e}")
                for m in SUBSAMPLING for q in (50, 75, 95)
                for r in (None, "blocks", "rows") for e in ENTROPY]
DECODE_CASES.append(pytest.param("420", 95, None, "c", [(680, 1200)], id="420-95-None-c-1200x680"))


@pytest.mark.parametrize("mode, quality, restart, entropy, sizes", DECODE_CASES)
def test_decode_matches_pil(mode, quality, restart, entropy, sizes):
    kw = {"restart_marker_blocks": 3} if restart == "blocks" else (
        {"restart_marker_rows": 1} if restart == "rows" else {})
    for i, (h, w) in enumerate(sizes):
        arr = _image(h, w, 1 if mode == "gray" else 3, seed=quality + i)
        data = _pil_jpeg(arr, quality, SUBSAMPLING[mode], **kw)
        assert (jpeg.parse(data).scans[0].restart > 0) == (restart is not None)
        ref = np.array(Image.open(io.BytesIO(data)))
        _assert_same(jpeg.decode(data, entropy=ENTROPY[entropy]).numpy(), ref)


def test_both_entropy_decoders_give_the_same_coefficients():
    data = _pil_jpeg(_image(64, 80, 3, 7), 90, 2, restart_marker_blocks=5)
    a = jpeg.decode_coefficients(data)[1]
    b = jpeg.decode_coefficients(data, entropy=jpeg.decode_scan_plain)[1]
    assert np.array_equal(a, b) and np.count_nonzero(a[4:]) > 1000


def test_single_component_scan_geometry():
    """A gray file's one scan walks its own blocks (T.81 A.2.2), not MCUs."""
    data = _pil_jpeg(_image(41, 53, 1, 3), 80)
    info = jpeg.parse(data)
    assert (info.mcus_x, info.mcus_y) == (7, 6) and info.comps[0].bw == 7
    _assert_same(jpeg.decode(data).numpy(), np.array(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("channels", [1, 3])
def test_encoder_files_decode_the_same_in_pil(channels, quality):
    arr = _image(45, 67, channels, seed=quality)
    data = jpeg.encode_jpeg(arr, quality)
    ref = np.array(Image.open(io.BytesIO(data)))
    mine = jpeg.decode(data).numpy()
    _assert_same(mine, ref)
    assert Image.open(io.BytesIO(data)).format == "JPEG"
    if channels == 3:
        assert Image.open(io.BytesIO(data)).layer == [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    # the quality-scaled Annex K tables, as libjpeg scales them for PIL
    pil = Image.open(io.BytesIO(_pil_jpeg(arr, quality, 2)))
    assert np.array_equal(np.array(pil.quantization[0]), jpeg.scaled_quant(quality)[0])
    # the round trip as close to the source as PIL's own encoder gets (4:2:0)
    pil_out = np.array(Image.open(io.BytesIO(_pil_jpeg(arr, quality, 2))))
    assert _psnr(mine, arr) > _psnr(pil_out, arr) - 0.5


def _psnr(a, b):
    return 10 * np.log10(255 ** 2 / ((a.astype(np.float64) - b) ** 2).mean())


def test_encoder_round_trip_of_a_smooth_frame():
    """A rendered-like frame (smooth) at quality 95: PSNR over 40 dB."""
    y, x = np.mgrid[0:68, 0:120]
    arr = np.stack([x * 2, y * 3, (x + y)], -1).astype(np.uint8)
    assert _psnr(jpeg.decode(jpeg.encode_jpeg(arr, 95)).numpy(), arr) > 40


def _sof_patched(data, marker=None, precision=None, sampling=None):
    """A copy of a baseline file with its SOF0 marker, precision or first
    component's sampling byte replaced."""
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if sampling is not None:
        b[i + 11] = sampling
    return bytes(b)


def _unsupported_files():
    rgb = _image(32, 48, 3, 0)
    base = _pil_jpeg(rgb, 75, 2)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, "JPEG")
    return {
        "rgb_colour_space": (_pil_jpeg(rgb, 75, 0, keep_rgb=True), "RGB-colour-space"),
        "progressive": (buf.getvalue(), "progressive"),
        "cmyk": (cmyk.getvalue(), "4-component"),
        "arithmetic": (_sof_patched(base, marker=0xC9), "arithmetic-coded"),
        "lossless": (_sof_patched(base, marker=0xC3), "lossless"),
        "12bit": (_sof_patched(base, precision=12), "12-bit"),
        "411": (_sof_patched(base, sampling=0x41), "chroma sampling 4x1"),
        "png": (image_io.encode_png(rgb), "not a JPEG"),
    }


@pytest.mark.parametrize("case", list(_unsupported_files()))
def test_unsupported_modes_raise(case):
    data, name = _unsupported_files()[case]
    with pytest.raises(ValueError, match=name):
        jpeg.decode(data)


@pytest.mark.parametrize("entropy", list(ENTROPY))
def test_corrupt_and_truncated_data_raise(entropy):
    data = _pil_jpeg(_image(32, 48, 3, 1), 75, 2, restart_marker_blocks=2)
    start = jpeg.parse(data).scans[0].start
    cases = [data[:start + 40] + b"\xff\xd9",  # truncated scan, then EOI
             data[:start] + b"\xff" * 64 + b"\xff\xd9",  # no code of 16 bits or fewer
             data.replace(b"\xff\xd1", b"\xff\xd5", 1)]  # restart markers out of order
    for bad in cases:
        with pytest.raises(ValueError, match="corrupt JPEG data"):
            jpeg.decode(bad, entropy=ENTROPY[entropy])
    with pytest.raises(ValueError, match="EOI"):
        jpeg.decode(data[:start + 40])


def test_fuzzed_files_raise_only_value_error():
    """Whole files truncated or bit-flipped anywhere (markers and tables
    too): each decodes or raises ValueError, never another exception."""
    rng = np.random.default_rng(4)
    data = _pil_jpeg(_image(40, 56, 3, 2), 75, 2, restart_marker_blocks=2)
    for i in range(600):
        b = bytearray(data)
        if i % 2:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        try:
            jpeg.decode(bytes(b))
        except ValueError:
            pass


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_entropy.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(jpeg, "SOURCE", str(bad))
    monkeypatch.setattr(image_io, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match="compiler failed"):
        jpeg.decode(_pil_jpeg(_image(16, 16, 3, 0), 75))


def test_frame_reader_takes_jpeg_by_its_bytes(tmp_path):
    """The loaders' reader decodes a JPEG named .png and a PNG named .jpg,
    as PIL does, on the CPU through the same host buffer as on a card."""
    from monogs_dev_tpu_torch.data.datasets import FrameReader

    arr = _image(24, 40, 3, 5)
    (tmp_path / "a.png").write_bytes(_pil_jpeg(arr, 85, 0))
    (tmp_path / "b.jpg").write_bytes(image_io.encode_png(arr))
    reader = FrameReader("cpu")
    a = reader.samples(str(tmp_path / "a.png")).numpy()
    _assert_same(a, np.array(Image.open(tmp_path / "a.png")))
    assert np.array_equal(reader.samples(str(tmp_path / "b.jpg")).numpy(), arr)


# ------------------------------------------------------------------ sanitizers

HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int png_unfilter(const uint8_t *, uint8_t *, int, int, int);
int jpeg_decode_scan(const uint8_t *, long long, long long, int, const int *, const int *,
                     const int *, const int *, const int *, const int *, const int *, int, int,
                     int, const uint8_t *, const uint8_t *, const int *, int16_t *, long long);
static FILE *f;
static void rd(void *p, size_t n) { if (fread(p, 1, n, f) != n) exit(3); }
static int32_t i32(void) { int32_t v; rd(&v, 4); return v; }
/* each buffer malloc'ed at its exact size, so that ASan sees any overrun */
static void *blob(size_t n) { void *p = malloc(n ? n : 1); rd(p, n); return p; }
int main(int argc, char **argv) {
    f = fopen(argv[1], "rb");
    if (!f) return 2;
    int32_t kind, count[2] = {0, 0}, fails = 0;
    while (fread(&kind, 4, 1, f) == 1) {
        if (kind == 0) {
            int32_t h = i32(), stride = i32(), bpp = i32(), n = i32();
            uint8_t *raw = blob((size_t)n);
            uint8_t *out = malloc((size_t)h * stride ? (size_t)h * stride : 1);
            fails += png_unfilter(raw, out, h, stride, bpp) != 0;
            free(raw); free(out);
        } else {
            int32_t n = i32(), start = i32(), ns = i32(), mx = i32(), my = i32(), rs = i32();
            int32_t a[7][4];
            for (int k = 0; k < 7; k++) for (int c = 0; c < 4; c++) a[k][c] = i32();
            int32_t present[8];
            for (int k = 0; k < 8; k++) present[k] = i32();
            int32_t cap = i32();
            uint8_t *bits = blob(8 * 16), *vals = blob(8 * 256), *data = blob((size_t)n);
            int16_t *coef = malloc((size_t)cap * 64 * sizeof(int16_t) + 1);
            fails += jpeg_decode_scan(data, n, start, ns, a[0], a[1], a[2], a[3], a[4], a[5],
                                      a[6], mx, my, rs, bits, vals, present, coef, cap) != 0;
            free(bits); free(vals); free(data); free(coef);
        }
        count[kind != 0]++;
    }
    printf("png %d jpeg %d rejected %d\n", count[0], count[1], fails);
    return 0;
}
"""


def _png_records(rng, n):
    out = []
    for _ in range(n):
        h, stride, bpp = int(rng.integers(1, 9)), int(rng.integers(0, 40)), int(rng.integers(1, 9))
        raw = rng.integers(0, 256, h * (stride + 1), dtype=np.uint8)
        raw[::stride + 1] = rng.integers(0, 7, h)  # filter types, some unknown
        out.append(struct.pack("<4i", 0, h, stride, bpp) + struct.pack("<i", raw.size)
                   + raw.tobytes())
    return out


def _jpeg_records(rng, n):
    """Truncated and bit-flipped copies of PIL files (every sampling, with
    and without restarts), with the geometry and tables parsed from the
    intact file, as the decoder hands them to the C function."""
    out = []
    files = [_pil_jpeg(_image(int(rng.integers(8, 48)), int(rng.integers(8, 48)), c, s), q, sub,
                       **kw)
             for s, (c, sub, q, kw) in enumerate([(1, None, 75, {}), (3, 0, 90, {}),
                                                  (3, 1, 60, {"restart_marker_blocks": 2}),
                                                  (3, 2, 95, {}),
                                                  (3, 2, 50, {"restart_marker_rows": 1})])]
    for i in range(n):
        data = files[i % len(files)]
        info = jpeg.parse(data)
        scan = info.scans[0]
        bits, vals, present = info.tables_at_scan[0]
        b = bytearray(data)
        kind = i % 3
        if kind == 0:  # truncated anywhere in the scan
            b = b[:int(rng.integers(scan.start, len(b)))]
        else:  # bits flipped in the scan's data (and in the tables, sometimes)
            for _ in range(int(rng.integers(1, 12))):
                p = int(rng.integers(scan.start, len(b)))
                b[p] ^= 1 << int(rng.integers(0, 8))
            if kind == 2:
                bits = bits.copy()
                vals = vals.copy()
                bits[int(rng.integers(0, 8)), int(rng.integers(0, 16))] = rng.integers(0, 256)
                vals[int(rng.integers(0, 8)), int(rng.integers(0, 256))] = rng.integers(0, 256)
        comps = [info.comps[c] for c in scan.comps]

        def pad(xs):
            xs = list(xs)
            return xs + [0] * (4 - len(xs))

        mx, my = jpeg._scan_grid(info, scan)
        arrays = [pad(c.h for c in comps), pad(c.v for c in comps), pad(c.bw for c in comps),
                  pad(c.bh for c in comps), pad(c.off for c in comps), pad(scan.dc),
                  pad(scan.ac)]
        rec = struct.pack("<7i", 1, len(b), scan.start, len(comps), mx, my, scan.restart)
        rec += struct.pack("<28i", *[v for a in arrays for v in a])
        rec += struct.pack("<8i", *[int(p) for p in present]) + struct.pack("<i", info.n_blocks)
        rec += np.ascontiguousarray(bits, np.uint8).tobytes()
        rec += np.ascontiguousarray(vals, np.uint8).tobytes() + bytes(b)
        out.append(rec)
    return out


def test_host_c_code_is_clean_under_sanitizers(tmp_path):
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    assert cc, "no host C compiler"
    (tmp_path / "harness.c").write_text(HARNESS)
    exe = str(tmp_path / "harness")
    build = subprocess.run([cc, "-std=c99", "-g", "-O1", "-fsanitize=address,undefined",
                            "-fno-sanitize-recover=all", "-fno-omit-frame-pointer", "-o", exe,
                            str(tmp_path / "harness.c"), os.path.join(CSRC, "png_unfilter.c"),
                            os.path.join(CSRC, "jpeg_entropy.c")],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    rng = np.random.default_rng(0)
    records = _png_records(rng, 150) + _jpeg_records(rng, 300)
    (tmp_path / "cases.bin").write_bytes(b"".join(records))
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    proc = subprocess.run([exe, str(tmp_path / "cases.bin")], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "runtime error" not in proc.stderr and "AddressSanitizer" not in proc.stderr
    png, jp, rejected = (int(v) for v in proc.stdout.split()[1::2])
    assert (png, jp) == (150, 300) and 0 < rejected < png + jp


def test_sanitizer_harness_catches_an_overrun(tmp_path):
    """The harness's buffers are exact: an unfilter told of a longer row
    than it was given is caught (the check above can fail)."""
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    (tmp_path / "harness.c").write_text(HARNESS)
    exe = str(tmp_path / "harness")
    subprocess.run([cc, "-std=c99", "-g", "-O1", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=all", "-o", exe, str(tmp_path / "harness.c"),
                    os.path.join(CSRC, "png_unfilter.c"), os.path.join(CSRC, "jpeg_entropy.c")],
                   check=True, capture_output=True)
    raw = bytes([0] + [1] * 8)  # one row of 8 bytes, announced as 16
    (tmp_path / "cases.bin").write_bytes(struct.pack("<5i", 0, 1, 16, 1, len(raw)) + raw)
    proc = subprocess.run([exe, str(tmp_path / "cases.bin")], capture_output=True, text=True,
                          timeout=60, env=dict(os.environ, ASAN_OPTIONS="detect_leaks=0"))
    assert proc.returncode != 0 and "AddressSanitizer" in proc.stderr
