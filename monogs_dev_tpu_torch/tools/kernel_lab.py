"""Blend-kernel lab: time the forward variants (L1) and the moments backward
(L2) beside the production kernels K1 and K2, on one scene's tile lists.

Counterpart of `tools/kernel_lab.py::main`, at its sizes: the 32,768-blob
lab scene (seed 0, scale 0.03) seen from the identity pose at VGA (fx 576),
binned with `max_per_tile` 512, `k_dup` 16, `tile_group` 60, and gathered
into (1200, 512, 10) tile props by the port's projection, binning and
gather. Variants:

  base     K1, the production forward
  bwd      K2, the production backward, on K1's residuals
  nocond, acc8, trimat, mxu, lean, storew, pair2, pair4
           L1 forward variants (ops/blend_lab.py)
  bwdmom   L2, the moments backward, on K1's residuals

Each line gives the variant's median time and its max |err| against base
(forward) or bwd (backward). On `cuda` times are CUDA events; `--device cpu`
runs the plain versions and times them on the host clock (CPU times, not
device metrics).

    python -m monogs_dev_tpu_torch.tools.kernel_lab [variants...] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from ..data.synthetic import load_lab_scene
from ..models.camera import Intrinsics
from ..ops import blend as B
from ..ops import blend_lab as BL
from ..ops.project import project_gaussians
from ..ops.raster_types import RasterConfig
from ..ops.rasterize import _tile_gather, build_binning, grid_dims, tile_wh

LAB_INTR = Intrinsics(fx=576.0, fy=576.0, cx=320.0, cy=240.0, width=640, height=480)
LAB_RASTER = RasterConfig(max_per_tile=512, k_dup=16, tile_group=60)
ALL_VARIANTS = ("base",) + BL.LAB_VARIANTS + ("bwd", "bwdmom")
DEFAULT_VARIANTS = ("base", "nocond", "trimat", "mxu", "lean")


def tile_props(params, active, T_w2c, intr: Intrinsics, rcfg: RasterConfig,
               dilate: float = 0.0):
    """Project, bin (tiles dilated by `dilate` px) and gather: per-tile props
    (T, L, 10), zero past each count, and counts (T,) int32."""
    with torch.no_grad():
        proj = project_gaussians(params, active, T_w2c, intr, 0)
        binning = build_binning(proj, intr, rcfg, dilate=dilate)
        props = torch.cat([proj.means2d, proj.conic, proj.color, proj.opacity[:, None],
                           proj.depth[:, None]], dim=-1)
        props_pad = torch.cat([props, props.new_zeros((1, 10))], dim=0)
        t_props = _tile_gather(props_pad, binning.idx_table, binning.pos_table).contiguous()
    return t_props, binning.counts


def median_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of `fn`: CUDA events on a card, the host clock
    on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def lab_cotangents(t_props, tw: int, th: int):
    """The TPU lab's cotangents: ones / size for color, depth and alpha."""
    n, p = t_props.shape[0], tw * th
    dev = t_props.device
    return (torch.full((n, 3, p), 1.0 / (n * 3 * p), device=dev),
            torch.full((n, p), 1.0 / (n * p), device=dev),
            torch.full((n, p), 1.0 / (n * p), device=dev))


def production_backward(t_props, counts, cots, tx_n, tile, rcfg: RasterConfig):
    """K2 on K1's residuals on a card; autograd through the plain blend on
    the CPU."""
    if t_props.is_cuda:
        t_final, n_done = BL.blend_residuals(t_props, counts, tx_n, tile, rcfg.alpha_clamp,
                                             rcfg.alpha_min, rcfg.transmittance_min)
        return B.blend_backward_cuda(t_props, t_final, n_done, *cots, tx_n, tile,
                                     rcfg.alpha_clamp, rcfg.alpha_min)
    with torch.enable_grad():
        pr = t_props.clone().requires_grad_(True)
        out = B.blend_tiles(pr, counts, tx_n, tile, rcfg.alpha_clamp, rcfg.alpha_min,
                            rcfg.transmittance_min, rcfg.tile_group)
        (g,) = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)), pr)
    return g


def run_lab(variants: Sequence[str], device, reps: int = 20, params=None, active=None,
            intr: Intrinsics = LAB_INTR, rcfg: RasterConfig = LAB_RASTER) -> Dict[str, dict]:
    """Run `variants` on the lab scene (or `params`/`active`, seen from the
    identity pose) and return {variant: {"ms", "err"}}; prints a line each."""
    device = torch.device(device)
    for v in variants:
        if v not in ALL_VARIANTS:
            raise ValueError(f"unknown variant {v!r}: one of {ALL_VARIANTS}")
    if params is None:
        params = load_lab_scene(device)
        active = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=device)
    t_props, counts = tile_props(params, active, torch.eye(4, device=device), intr, rcfg)
    tw, th = tile_wh(rcfg)
    tx_n, _, _ = grid_dims(intr, tw, th)
    tile = (tw, th)
    cfg = (rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    print(f"counts mean/max: {float(counts.float().mean()):.1f} {int(counts.max())} "
          f"(props {tuple(t_props.shape)}, {int(counts.sum())} entries)", flush=True)

    results: Dict[str, dict] = {}
    ref_fwd = ref_bwd = None
    cots = lab_cotangents(t_props, tw, th)
    with torch.no_grad():
        for v in variants:
            if v == "base":
                fn = lambda: B.blend_tiles(t_props, counts, tx_n, tile, *cfg, rcfg.tile_group)
            elif v in BL.LAB_VARIANTS:
                fn = lambda v=v: BL.lab_blend(v, t_props, counts, tx_n, tile, *cfg,
                                              rcfg.tile_group)
            elif v == "bwd":
                fn = lambda: production_backward(t_props, counts, cots, tx_n, tile, rcfg)
            else:  # bwdmom
                t_final, n_done = BL.blend_residuals(t_props, counts, tx_n, tile, *cfg,
                                                     rcfg.tile_group)
                fn = lambda: BL.moments_backward(t_props, t_final, n_done, *cots, tx_n, tile,
                                                 *cfg[:2], rcfg.tile_group)
            out = fn()
            res = {"ms": median_ms(fn, device, reps), "err": None}
            if v == "base":
                ref_fwd = out
            elif v == "bwd":
                ref_bwd = out
            elif v == "bwdmom" and ref_bwd is not None:
                res["err"] = float((out - ref_bwd).abs().max())
            elif v in BL.LAB_VARIANTS and ref_fwd is not None:
                res["err"] = [float((a - b).abs().max()) for a, b in zip(out, ref_fwd)]
            results[v] = res
            what = "bwd" if v.startswith("bwd") else "fwd"
            ref = "bwd" if what == "bwd" else "base"
            err = f"  max|err| vs {ref}: {res['err']}" if res["err"] is not None else ""
            print(f"{v} {what}: {res['ms']:.4f} ms{err}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"any of {ALL_VARIANTS}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the lab times the kernels on a card "
                         "(--device cpu runs the plain versions)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    run_lab(args.variants or DEFAULT_VARIANTS, device, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
