"""Per-tile front-to-back alpha blending: the CUDA kernels and their plain version.

Counterpart of `monogs_dev_tpu/ops/blend_pallas.py`. Three kernels live in
`csrc/blend.cu`:

  K1  forward blend (replaces the Pallas `_blend_fwd_kernel`, emit_touch=False)
  K3  forward blend plus per-entry touch counts (emit_touch=True)
  K2  back-to-front replay backward (replaces `_blend_bwd_kernel`)

They are compiled with `nvcc` for `sm_90a` at first use into `build/`,
together with the first version of the same kernels (`csrc/blend_v1.cu`,
kept as a yardstick: `forward_launcher`/`backward_launcher` with
`version=1`, which count no launch; nothing of the system calls them) and
the kernel lab's `csrc/blend_lab.cu` and its first version
`csrc/blend_lab_v1.cu` (ops/blend_lab.py), into one library called through
`ctypes`. `blend_tiles` / `blend_tiles_touch` dispatch on
the device of `props`: a CUDA tensor goes to the kernels (a build or launch
failure raises), a CPU tensor goes to `blend_tiles_reference`, the plain
torch port of the JAX package's `_blend_group` (ops/rasterize.py), whose
gradient is torch autograd through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, List, Tuple

import torch

D_IN = 10
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# each source with its own flags: version 2 (blend.cu, blend_lab.cu) rounds
# power, alpha and the transmittance by hand and lets the rest contract to
# FMA; the first versions are held to their plain versions as compiled with
# no contraction at all
SOURCE_FLAGS: Dict[str, List[str]] = {
    "blend.cu": [],
    "blend_v1.cu": ["-fmad=false"],
    "blend_lab.cu": [],
    "blend_lab_v1.cu": ["-fmad=false"],
}
SOURCES = [os.path.join(_PKG, "csrc", name) for name in SOURCE_FLAGS]

# launches per kernel; each wrapper adds one where it launches its kernel
# (L1 and L2 are the kernel lab's, ops/blend_lab.py)
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "L1": 0, "L2": 0}

_lib = None
_lib_lock = threading.Lock()
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the blend kernels need the CUDA toolkit")


def compile_commands(nvcc: str, obj_dir: str, verbose: bool = False) -> List[List[str]]:
    """One `nvcc -c` command line per source, with its own flags, writing
    `<obj_dir>/<source>.o`."""
    extra = ["-Xptxas", "-v"] if verbose else []
    return [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[os.path.basename(src)], *extra, "-c", "-o",
             os.path.join(obj_dir, os.path.basename(src) + ".o"), src] for src in SOURCES]


def library_path() -> str:
    """`build/libblend_<key>.so`, the key a hash of the flags and sources."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES:
        h.update(" ".join(SOURCE_FLAGS[os.path.basename(path)]).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libblend_{h.hexdigest()[:12]}.so")


def build(verbose: bool = False) -> Tuple[str, float]:
    """Compile the sources into one library (`library_path`) and return
    (library path, seconds spent compiling; 0.0 when already built). Each
    source gets its own `nvcc`, all started together; one more links them."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        cmds = compile_commands(nvcc, tmp_dir, verbose)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        logs = [(src, proc.communicate()[1], proc.returncode) for src, proc in zip(SOURCES, procs)]
        failed = [f"{src}:\n{err}" for src, err, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        if verbose:
            for _, err, _ in logs:
                print(err, end="")
        objs = [cmd[-2] for cmd in cmds]
        lib = os.path.join(tmp_dir, "lib.so")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {objs}:\n{proc.stderr}")
        os.replace(lib, out)
    return out, time.time() - t0


# the C entry points (forward, backward) of each version of K1-K3, and of
# the lab's L1 and L2 (ops/blend_lab.py)
_ENTRIES = {2: ("blend_fwd", "blend_bwd"), 1: ("blend_fwd_v1", "blend_bwd_v1")}
LAB_ENTRIES = {2: ("lab_blend_fwd", "lab_moments_bwd"), 1: ("lab_blend_fwd_v1", "lab_moments_bwd_v1")}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for fwd, bwd in _ENTRIES.values():
                getattr(lib, fwd).argtypes = [
                    _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                    _c_float, _c_float, _c_float,
                    _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                    _c_void_p, _c_void_p,
                ]
                getattr(lib, fwd).restype = _c_int
                getattr(lib, bwd).argtypes = [
                    _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                    _c_float, _c_float,
                    _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                    _c_void_p, _c_void_p,
                ]
                getattr(lib, bwd).restype = _c_int
            for fwd, bwd in LAB_ENTRIES.values():
                getattr(lib, fwd).argtypes = [
                    _c_int, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                    _c_float, _c_float, _c_float, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                ]
                getattr(lib, fwd).restype = _c_int
                getattr(lib, bwd).argtypes = [
                    _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_float,
                    _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                    _c_void_p,
                ]
                getattr(lib, bwd).restype = _c_int
            _lib = lib
    return _lib


def _tile_wh(tile) -> Tuple[int, int]:
    return tile if isinstance(tile, tuple) else (tile, tile)


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _tile_pixels(tile) -> Tuple[int, int, int]:
    """(tile_w, tile_h, pixels) of a tile the kernels take: one thread per
    pixel, whole warps, one block."""
    tw, th = _tile_wh(tile)
    p = tw * th
    if p % 32 or p > 1024:
        raise ValueError(f"tile of {p} pixels: need a multiple of 32 up to 1024")
    return tw, th, p


def forward_launcher(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                     emit_touch: bool, version: int = 2) -> Tuple[Callable[[], None], tuple]:
    """Check the inputs of K1 (K3 with `emit_touch`) and allocate its
    outputs: color (T,3,P), depth (T,P), alpha (T,P), t_final (T,P), n_done
    (T,P) int32 and touch (T,L) int32 or None. Returns (launch, outputs):
    `launch()` runs the kernel of `version` (2, or the first version 1) into
    those outputs through its C entry point on the current stream, and does
    no other host work than the call, so that repeated launches time the
    kernel alone. It counts no launch."""
    tw, th, p = _tile_pixels(tile)
    t, l, d = props.shape
    _check(props, "props", torch.float32, (t, l, D_IN))
    _check(counts, "counts", torch.int32, (t,))
    name = _ENTRIES[version][0]
    fn = getattr(_load(), name)
    dev = props.device
    color = torch.empty((t, 3, p), dtype=torch.float32, device=dev)
    depth = torch.empty((t, p), dtype=torch.float32, device=dev)
    alpha = torch.empty((t, p), dtype=torch.float32, device=dev)
    t_final = torch.empty((t, p), dtype=torch.float32, device=dev)
    n_done = torch.empty((t, p), dtype=torch.int32, device=dev)
    touch = torch.zeros((t, l), dtype=torch.int32, device=dev) if emit_touch else None
    args = (props.data_ptr(), counts.data_ptr(), t, l, int(tx_n), tw, th,
            float(alpha_clamp), float(alpha_min), float(t_min),
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            t_final.data_ptr(), n_done.data_ptr(),
            touch.data_ptr() if emit_touch else None,
            torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        _raise_on(fn(*args), name)

    return launch, (color, depth, alpha, t_final, n_done, touch)


def backward_launcher(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile,
                      alpha_clamp, alpha_min,
                      version: int = 2) -> Tuple[Callable[[], None], torch.Tensor]:
    """K2's counterpart of `forward_launcher`: checks the inputs, allocates
    d_props (T, L, 10) (zero: the kernel writes the entries some pixel
    multiplied in) and returns (launch, d_props)."""
    tw, th, p = _tile_pixels(tile)
    t, l, _ = props.shape
    _check(props, "props", torch.float32, (t, l, D_IN))
    _check(t_final, "t_final", torch.float32, (t, p))
    _check(n_done, "n_done", torch.int32, (t, p))
    _check(g_color, "g_color", torch.float32, (t, 3, p))
    _check(g_depth, "g_depth", torch.float32, (t, p))
    _check(g_alpha, "g_alpha", torch.float32, (t, p))
    name = _ENTRIES[version][1]
    fn = getattr(_load(), name)
    d_props = torch.zeros((t, l, D_IN), dtype=torch.float32, device=props.device)
    args = (props.data_ptr(), t, l, int(tx_n), tw, th, float(alpha_clamp), float(alpha_min),
            t_final.data_ptr(), n_done.data_ptr(), g_color.data_ptr(), g_depth.data_ptr(),
            g_alpha.data_ptr(), d_props.data_ptr(),
            torch.cuda.current_stream(props.device).cuda_stream)

    def launch() -> None:
        _raise_on(fn(*args), name)

    return launch, d_props


def blend_forward_cuda(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                       emit_touch: bool):
    """Launch K1 (or K3 with `emit_touch`). Returns color (T,3,P), depth (T,P),
    alpha (T,P), t_final (T,P), n_done (T,P) int32 and touch (T,L) int32 or
    None."""
    launch, out = forward_launcher(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                                   emit_touch)
    launch()
    LAUNCHES["K3" if emit_touch else "K1"] += 1
    return out


def blend_backward_cuda(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n,
                        tile, alpha_clamp, alpha_min):
    """Launch K2: d_props (T, L, 10) from the forward's residuals."""
    launch, d_props = backward_launcher(props, t_final, n_done, g_color, g_depth, g_alpha,
                                        tx_n, tile, alpha_clamp, alpha_min)
    launch()
    LAUNCHES["K2"] += 1
    return d_props


class _BlendCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                emit_touch):
        props = props.contiguous()
        color, depth, alpha, t_final, n_done, touch = blend_forward_cuda(
            props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, emit_touch
        )
        ctx.save_for_backward(props, t_final, n_done)
        ctx.cfg = (tx_n, tile, alpha_clamp, alpha_min)
        if emit_touch:
            ctx.mark_non_differentiable(touch)
            return color, depth, alpha, touch
        return color, depth, alpha

    @staticmethod
    def backward(ctx, g_color, g_depth, g_alpha, *_):
        props, t_final, n_done = ctx.saved_tensors
        tx_n, tile, alpha_clamp, alpha_min = ctx.cfg

        def dense(g, shape):
            return torch.zeros(shape, dtype=props.dtype, device=props.device) if g is None else g.contiguous()

        d_props = blend_backward_cuda(
            props, t_final, n_done,
            dense(g_color, t_final.shape[:1] + (3,) + t_final.shape[1:]),
            dense(g_depth, t_final.shape), dense(g_alpha, t_final.shape),
            tx_n, tile, alpha_clamp, alpha_min,
        )
        return d_props, None, None, None, None, None, None, None


def blend_tiles_reference(props, counts, tx_n, tile=16, alpha_clamp=0.99,
                          alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """Plain torch blend (port of `_blend_group`), run in groups of
    `tile_group` tiles so the dense (T, L, P) intermediates stay small.
    Entries at or past `counts[t]` are masked. Returns color (T,3,P),
    depth (T,P), alpha (T,P), touch (T,L) int32."""
    tw, th = _tile_wh(tile)
    n_tiles, l_max, _ = props.shape
    dev = props.device
    ly, lx = torch.meshgrid(
        torch.arange(th, device=dev, dtype=torch.float32),
        torch.arange(tw, device=dev, dtype=torch.float32),
        indexing="ij",
    )
    lx, ly = lx.reshape(-1), ly.reshape(-1)
    slots = torch.arange(l_max, device=dev)
    outs = []
    for g0 in range(0, n_tiles, tile_group):
        g1 = min(g0 + tile_group, n_tiles)
        pr = props[g0:g1]
        tid = torch.arange(g0, g1, device=dev)
        ox = ((tid % tx_n) * tw).to(torch.float32)
        oy = ((tid // tx_n) * th).to(torch.float32)
        px = ox[:, None] + lx[None, :]  # (G, P)
        py = oy[:, None] + ly[None, :]
        live = (slots[None, :] < counts[g0:g1, None])[..., None]  # (G, L, 1)
        dx = px[:, None, :] - pr[..., 0:1]  # (G, L, P)
        dy = py[:, None, :] - pr[..., 1:2]
        ca, cb, cc = pr[..., 2:3], pr[..., 3:4], pr[..., 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = pr[..., 8:9] * torch.exp(power)
        alpha = torch.where(raw < alpha_clamp, raw, torch.full_like(raw, alpha_clamp))
        cut = (power > 0.0) | (alpha < alpha_min) | ~live
        alpha = torch.where(cut, torch.zeros_like(alpha), alpha)
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
        contributing = t_excl >= t_min
        w = torch.where(contributing, alpha * t_excl, torch.zeros_like(alpha))
        color = torch.einsum("glp,glc->gcp", w, pr[..., 5:8])
        depth = torch.einsum("glp,gl->gp", w, pr[..., 9])
        touch = ((alpha >= alpha_min) & contributing & live).sum(dim=2)
        outs.append((color, depth, w.sum(dim=1), touch.to(torch.int32)))
    return tuple(torch.cat(x, dim=0) for x in zip(*outs))


def entry_reach_reference(props: torch.Tensor, alpha_min: float = 1.0 / 255.0):
    """Plain twin of the kernels' `entry_reach` (csrc/blend.cu, blend_lab.cu),
    for the tests: per entry of props (..., 10), the half-widths (rx, ry) of
    the box around its mean outside which its alpha is below alpha_min, in
    float32 with the kernel's expressions (its fast log, division and rsqrt
    taken exactly). -inf: the entry reaches no pixel; +inf: no bound."""
    ca, cb, cc, op = props[..., 2], props[..., 3], props[..., 4], props[..., 8]
    am = torch.tensor(alpha_min, dtype=torch.float32)
    tau = 2.02 * torch.log(op / am) + 1e-3
    det_lo = ca * cc - cb * cb - 1e-3 * ((ca * cc).abs() + cb * cb)
    bounded = (am > 0.0) & (ca > 0.0) & (cc > 0.0) & (det_lo > 0.0) & (tau > 0.0)
    s = tau / det_lo
    x, y = s * cc, s * ca
    inf = torch.full_like(x, float("inf"))
    out = []
    for v in (x, y):
        r = torch.where(bounded, 1.001 * v * torch.rsqrt(v) + 0.01, inf)
        out.append(torch.where(op < am, -inf, r))
    return out[0], out[1]


def _dispatch(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, emit_touch,
              tile_group):
    if props.is_cuda:
        return _BlendCuda.apply(
            props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, emit_touch
        )
    if props.device.type != "cpu":
        raise ValueError(f"blend: unsupported device {props.device}")
    out = blend_tiles_reference(
        props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, tile_group
    )
    return out if emit_touch else out[:3]


def blend_tiles(props, counts, tx_n, tile=16, alpha_clamp=0.99,
                alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """(color (T,3,P), depth (T,P), alpha (T,P)) from per-tile props
    (T, L, 10); differentiable w.r.t. props. CUDA: K1 forward, K2 backward."""
    return _dispatch(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                     False, tile_group)


def blend_tiles_touch(props, counts, tx_n, tile=16, alpha_clamp=0.99,
                      alpha_min=1.0 / 255.0, t_min=1e-4, tile_group=60):
    """`blend_tiles` plus touch (T, L) int32: per entry, the pixels where it
    had alpha >= alpha_min while transmittance was >= t_min. CUDA: K3
    forward, K2 backward."""
    return _dispatch(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min,
                     True, tile_group)
