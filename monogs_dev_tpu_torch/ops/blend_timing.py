"""Times of the blend kernels on a card and their bound: the measure that
`chip_smoke.py` and `tools/run_fixture_evals.py` share.

`kernel_ms` times zero-argument launchers (`ops/blend.py::forward_launcher`,
`backward_launcher`, the lab's; `chip_smoke.py` makes them) kernel-only;
`bound` is the least time an H100 could take for the same work;
`blend_kernel_times` runs both for K1, K3 and K2 on one set of per-tile
props through the counted wrappers, as only `ops/blend.py` may call the
launchers (tests/test_torch_blend.py). Card only: on the CPU there is no
kernel to time.
"""

from __future__ import annotations

import statistics

import torch

# kernel-only timing: median over ROUNDS rounds of BURST launches, each
# burst queued behind ~1 ms of device sleep
ROUNDS, BURST, SLEEP_CYCLES = 21, 20, 2_000_000
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# fp32 ops per (entry, pixel) pair whose alpha the blend uses, counted from
# the sources (expf, log1pf and a division as one op each, compares counted;
# the gradients' pixel sums as one add per component): K1 29, K3 30 (+ the
# touch test), L1 32 (trimat 34, rank-6 31), K2 63 (an alpha at its clamp
# skips 22 of them), L2 61 (40 in the pixel pass, 11 moments FFMA)
OPS_PER_PAIR = {"K1": 29, "K3": 30, "K2": 63, "L2": 61, "L1": 32, "L1/trimat": 34,
                "L1/mxu": 31, "L1/lean": 31}
# finding those pairs (csrc/blend.cu): an entry's reach box (`entry_reach`,
# 27 ops), and the box against a warp's 32-pixel strip (`misses`, 6 ops)
REACH_OPS, STRIP_OPS = 27, 6


def bound(name, counts, n_done, touch, p):
    """(bound_ms, bound_by) of kernel `name` on one call: bytes over HBM_BPS
    against ops over FP32_OPS. Bytes count the blended entries' props
    (sum(counts) x 40 B) and the per-pixel tensors once. Ops count the work
    this run's data needs, the same for every kernel of one function:
    OPS_PER_PAIR for each pair of a pixel and an entry it multiplies in with
    alpha >= alpha_min (sum(touch), exact: the plain version's touch counts
    just those pairs); the other pairs have alpha 0 and add nothing. Finding
    them costs REACH_OPS per entry up to the last one its tile multiplies in
    and STRIP_OPS per (entry, 32-pixel strip) up to the strip's last."""
    entries = float(counts.sum())
    t = counts.shape[0]
    px_bytes = 4.0 * t * p
    if name.startswith("L1"):
        nbytes = 40 * entries + 4 * t + 5 * px_bytes
    elif name in ("K2", "L2"):
        nbytes = 40 * entries + 7 * px_bytes + 40 * entries  # props in, d_props out
    else:  # K1, K3: color, depth, alpha, t_final, n_done (+ touch)
        nbytes = 40 * entries + 4 * t + 7 * px_bytes + (4 * entries if name == "K3" else 0)
    strips = n_done.reshape(t, p // 32, 32).amax(dim=2)  # entries each strip multiplies in
    ops = (float(touch.sum()) * OPS_PER_PAIR.get(name, OPS_PER_PAIR[name[:2]])
           + REACH_OPS * float(strips.amax(dim=1).sum()) + STRIP_OPS * float(strips.sum()))
    t_bytes, t_ops = nbytes / HBM_BPS, ops / FP32_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_ms(launchers) -> dict:
    """Kernel-only milliseconds per launch of each zero-argument launcher
    (a C entry point into preallocated outputs, ops/blend.py; a wrapper's
    call adds the device work of its allocations): the median
    over ROUNDS rounds of BURST back-to-back launches between two CUDA
    events, the launchers in turns (in reverse order in every other round).
    Each burst is queued behind a device sleep, so the host's launch cost
    stays out of the window."""
    for fn in launchers.values():
        fn()
    torch.cuda.synchronize()
    names = list(launchers)
    times = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in names if r % 2 == 0 else names[::-1]:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            s.record()
            for _ in range(BURST):
                launchers[n]()
            e.record()
            e.synchronize()
            times[n].append(s.elapsed_time(e) / BURST)
    return {n: statistics.median(v) for n, v in times.items()}


def blend_kernel_times(t_props, counts, tx_n, rcfg) -> dict:
    """K1, K3 and K2 on per-tile props on a card, each timed by `kernel_ms`
    through its counted wrapper (`ops/blend.py::blend_forward_cuda`,
    `blend_backward_cuda`; K2 on K1's t_final and n_done with random seeded
    cotangents), with its bound: {name: {ms, bound_ms, bound_by, gap}}, gap =
    ms / bound_ms. The device sleep before each burst hides the wrappers'
    host work, so a time is the kernel's plus the zero fill of the output
    it writes only in part (K3's touch counts, K2's d_props)."""
    from . import blend as B
    from .rasterize import tile_wh

    tw, th = tile_wh(rcfg)
    p = tw * th
    t = t_props.shape[0]
    cargs = (tx_n, (tw, th), rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    with torch.no_grad():
        k1 = B.blend_forward_cuda(t_props, counts, *cargs, False)
        touch = B.blend_forward_cuda(t_props, counts, *cargs, True)[5]
        gen = torch.Generator(device=t_props.device).manual_seed(0)
        g_color = torch.randn((t, 3, p), generator=gen, device=t_props.device)
        g_depth = 0.1 * torch.randn((t, p), generator=gen, device=t_props.device)
        g_alpha = torch.randn((t, p), generator=gen, device=t_props.device)
        bwd_args = (t_props, k1[3], k1[4], g_color, g_depth, g_alpha, tx_n, (tw, th),
                    rcfg.alpha_clamp, rcfg.alpha_min)
        ms = kernel_ms({
            "K1": lambda: B.blend_forward_cuda(t_props, counts, *cargs, False),
            "K3": lambda: B.blend_forward_cuda(t_props, counts, *cargs, True),
            "K2": lambda: B.blend_backward_cuda(*bwd_args),
        })
    out = {}
    for name in ("K1", "K3", "K2"):
        b, by = bound(name, counts, k1[4], touch, p)
        out[name] = {"ms": ms[name], "bound_ms": b, "bound_by": by, "gap": ms[name] / b}
    return out
