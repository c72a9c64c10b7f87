#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (fails without a CUDA device);
2. build: compiles the blend kernels (monogs_dev_tpu_torch/csrc) with nvcc,
   linked to the shared CUDA runtime (checked: one libcudart in the
   process, the library's and torch's), and the PNG unfilter
   (csrc/png_unfilter.c) and the JPEG entropy decoder
   (csrc/jpeg_entropy.c) with the host C compiler;
3. kernels: K1, K3 and K2 at the bench shapes (VGA, 16x16 tiles, L = 512),
   on props from the port's projection, binning and gather of the bench
   scene at frame 0, each held against its plain torch version on the card
   and against the first version of the kernels (csrc/blend_v1.cu), and
   timed: kernel-only (the C entry point into preallocated outputs, 20
   launches back to back between two CUDA events, median of 21 such runs)
   in turns with the first version, through the wrapper, and the plain
   version; then every L1 variant and L2 of the kernel lab the same way
   against their plain versions and their first version
   (csrc/blend_lab_v1.cu) (`check_lab`);
4. slice: `configs/synthetic/bench_vga.yaml` (RGB-D, Gauss-Newton tracking)
   through `SLAM`, the code path of `slam_torch.py`: frames 0..11 for the
   tracked frames/s, with the kernel launch counts of that run;
5. parity: `configs/synthetic/bench_vga_parity.yaml` (RGB-D, the
   reference's Adam tracking loop: the pose gradient through K1/K2 at every
   iteration) through `SLAM`, the code path of `slam_torch.py --eval`:
   frames 0..11 for the tracked frames/s, the Adam iterations a frame, the
   launch counts and the ATE (the Adam loop on to a keyframe runs in the
   ingest phase, on fr3_office's config); PARITY_PROFILE_FRAMES profiled
   frames; the first iteration's loss and gradient at one frame of the run,
   kernels against the plain blend (`gradient_check`); on the same frame
   the projection's kernels P1/P2 against their plain versions, timed, and
   the tracker's frame run again through them alone (`projection_check`,
   the `projection:` line); then
   `SLAM.evaluate` (colour refinement, PSNR/SSIM/LPIPS before and after,
   the ATE, PSNR-json and PLY artifacts in a temporary directory);
6. lab: the kernel lab's entry point (`monogs_dev_tpu_torch/tools/
   kernel_lab.py`, every variant) on the lab scene at the lab's size, with
   the launch counts of that run; phase 3 on the lab scene. On the lab
   scene, the post-init map and the monocular init map L2 is also held to
   autograd through the plain blend, with no more entries outside
   tolerance against float64 autograd than its first version;
7. monocular: `configs/synthetic/bench_vga.yaml` forced monocular through
   `SLAM`, the code path of `bench_torch.py`: warm-up until the frontend and
   backend are initialized (by frame 162), MONO_MEAS timed frames, and the checks
   (finite poses, a full window of keyframes, scale-corrected keyframe ATE
   under 8 cm, K1/K2/K3 launched in the run);
   then PROFILE_FRAMES more frames under `torch.profiler` (each K kernel's
   device ms per frame, the device's idle share);
8. map kernels: phase 3 again on the maps after the RGB-D init mapping,
   at the monocular initialization, after the ingest run's first
   keyframe (L = 1024) and at the replay run's initialization, binned as
   the mapping loop bins them;
9. ingest (`ingest_phase`): writes a TUM-layout sequence of the bench
   scene along bench_vga's orbit
   at fr3_office's calibration (640x480, 16-bit depth at scale 5000) and
   runs `configs/rgbd/tum/fr3_office.yaml` on it through the TUM loader, as
   committed but for `dataset_path` and `save_results`: frames 0..11 for
   the tracked frames/s, then on to the first keyframe after frame 0
   within INGEST_BUDGET_S; the map tiers (`tier_phase`: that map compacted
   to a smaller tier and grown back, against the same steps on the CPU and
   against its full render); saves a checkpoint right after that keyframe's
   mapping, checks `load_map` of it against the map bit for bit, resumes
   it in a fresh `SLAM` and runs RESUME_FRAMES more frames (the `tum:`
   line); the dp phase (`dp_phase`, the `dp:` lines): the same checkpoint
   resumed with `TPU.mesh_devices: 2` (a mesh of the visible cards, one on
   a one-card machine), every mapping round through the data-parallel step,
   RESUME_FRAMES frames, then the TUM run's own state one frame before its
   keyframe resumed into it and on until that keyframe's round has mapped,
   with K1-K3 counted under path `dp`; then one step at full width (10 VGA
   slots) over the meshes
   [cuda:0, cuda:0] and [cuda:0], held to each other at
   tests/test_parallel.py's bounds (on one card the replicas are the lead's
   own tensors; with two cards [cuda:0, cuda:1] too, its replicas equal to
   the lead's map bit for bit), and timed beside the single path's mapping
   iterations; the thread phase (`thread_phase`, the
   `thread:` line): the same checkpoint resumed with `TPU.scheduler:
   thread` and `Results.use_gui`, a headless viewer thread rendering each
   packet, the same frames in turns with a second inline resumed run, then
   the TUM run's own state one frame before its keyframe resumed into it
   and on until the backend thread has mapped that keyframe while the
   frontend tracked, and the hand-off's snapshot checksums (no frame
   profiled: `profile_frames` runs with no other thread alive);
   then writes a EuRoC-layout stereo
   sequence (320x240, EUROC_FRAMES frames)
   and runs the EuRoC base config on it through the rectification and the
   matcher (the `euroc:` line). Both fetch a few frames again under torch's
   sync debug mode set to raise (`assert_loader_never_waits`);
10. replica (`replica_phase`, the `replica:` lines): writes a Replica-layout
   sequence of the bench scene (JPEG colour, 16-bit depth) on the card and
   runs `configs/rgbd/replica/office0_sp.yaml` as committed (1200x680) on it
   through the Replica loader and the port's JPEG decoder, to its first
   keyframe after frame 0; the fetch under sync debug mode; every frame's
   decode on the card against the CPU's, bit for bit; K1-K3 under path
   `replica`;
11. replay (`replay_phase`, the `replay:` line): writes the first
   REPLAY_FRAMES frames of the fixture-eval tool's Realsense-replay
   sequence (`monogs_dev_tpu_torch/tools/run_fixture_evals.py`: the JAX
   replay writer's scene, 120 frames along the ease-in orbit, 640x480) on
   the card and runs `configs/live/realsense_replay.yaml` with the tool's
   overrides through `load_dataset` (`RealsenseReplayDataset`) and `SLAM`
   (monocular, 10x position_lr_init, rebinning every 4 mapping iterations):
   the map's initialization at frame 0 (bootstrap depth, initial BA), then
   on until the first keyframe after it has been mapped, within
   REPLAY_BUDGET_S; checks finite poses, no monocular reset (a second
   initialization), the Sim(3)-aligned ATE of every frame against the
   sequence's `gt_poses.npy` (the loader's poses are identity), K1-K3
   under path `replay`, the fetch under sync debug mode; no frame
   profiled. Phase 3 runs again on its map at initialization (L = 512);
12. scale (`scale_phase`, the `scale:` lines):
   `configs/synthetic/scale_vga.yaml` as committed (640x480, capacity
   131,072, small tier 65,536, densify budgets 8,192 / 4,096, the committed
   24,000-Gaussian surface scene) through `SLAM` from frame 0 to its first
   keyframe after the initialization; then the map compacted to the power
   of two above its alive rows plus 8 (the visibility remapped with it) and
   run on until a keyframe's insert grows it back to 131,072 rows and that
   keyframe's mapping round has run, within SCALE_BUDGET_S; checks the
   growth, every map field finite, finite poses, K1-K3 under path `scale`
   (the whole 240-frame sweep runs in `run_fixture_evals.py scale`).

Before the last lines it fails if a thread that Python code started (the
backend's, a viewer's) is still alive: none may run into the teardown.

The line before the last lists every kernel with its launches, its largest
error against its plain version, its time, the plain version's time and
its bound on an H100 (`bound_ms`: the larger of the bytes it must move over
3.35 TB/s and the fp32 operations this run's data needs over 67 TFLOP/s;
`kernel_ms` and `bound` are `monogs_dev_tpu_torch/ops/blend_timing.py`'s);
each also with the first version's time (`ms_v1`), the wrapper's
(`wrapper_ms`) and all of these on every prop set (`sets`). The last line
is {"ok": true, "device": {...}}; any failed check exits non-zero before it.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# kernel-only times and the H100 bound, shared with tools/run_fixture_evals.py
from monogs_dev_tpu_torch.ops.blend_timing import bound, kernel_ms  # noqa: E402
CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga.yaml")
PARITY_CONFIG = os.path.join(REPO, "configs", "synthetic", "bench_vga_parity.yaml")
N_FRAMES = 12  # frames 2..11 give the tracked frames/s
TOL = {"color": 3e-5, "alpha": 3e-5, "depth": 3e-4}
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5  # atol: fp32 sums of ~256 pixel terms in another order
# L2's absolute floor, relative to the largest gradient (as tests/test_torch_gpu.py
# holds K2): on the lab scene (max |grad| ~500) float32 autograd itself misses
# the absolute 1e-5 floor against float64 autograd (PERF.md, Findings)
L2_ATOL_REL = 1e-5
MONO_FRAME_CAP = 162  # bench.py:106: the last warm-up frame that leaves 25 to time
# the monocular run's timed frames after initialization (bench_torch.N_MEAS,
# 25, until the replay phase took their time)
MONO_MEAS = 15
MONO_ATE_BAR = 0.08  # tests/test_system.py:317
SOURCES = {"K": "monogs_dev_tpu_torch/csrc/blend.cu", "L": "monogs_dev_tpu_torch/csrc/blend_lab.cu"}
REPLACES = {
    "K1": "monogs_dev_tpu/ops/blend_pallas.py:177",
    "K3": "monogs_dev_tpu/ops/blend_pallas.py:211",
    "K2": "monogs_dev_tpu/ops/blend_pallas.py:322",
    "L1": "tools/kernel_lab.py:418",
    "L2": "tools/kernel_lab.py:479",
}
# monocular frames profiled after the timed window, fewer where the sequence
# ends first (20 until the parity phase took their time, 8 until the
# ingest's, 4 until the dp phase's)
PROFILE_FRAMES = 2
# profiler kernel names of K1-K3
PROFILE_NAMES = {"K1": "blend_fwd_kernel_v2<false>", "K3": "blend_fwd_kernel_v2<true>",
                 "K2": "blend_bwd_kernel_v2", "P1": "project_fwd_kernel",
                 "P2": "project_bwd_pose"}
# the projection's kernels against their plain versions (ops/project.py):
# P1's continuous fields within PROJ_REL relative (radii and valid equal),
# P2's pose gradient within POSE_GRAD_REL x its largest entry
PROJ_REL, POSE_GRAD_REL = 2e-6, 1e-5
# parity phase: frames 0..11 (until the ingest phase's fr3_office run took
# the Adam loop on to a keyframe, the run went on to frame 45); the Adam
# tracker's first iteration at PARITY_GRAD_FRAME is checked kernels against
# the plain blend (gradient within GRAD_CHECK_REL x max|g|, loss within
# LOSS_CHECK_REL relative); PARITY_PROFILE_FRAMES more frames are profiled
PARITY_GRAD_FRAME = 6
GRAD_CHECK_REL, LOSS_CHECK_REL = 1e-3, 1e-5
PARITY_PROFILE_FRAMES = 1
RGBD_ATE_BAR = 0.03  # PERF.md section 2
# ingest phase: the TUM-layout sequence (the bench scene along bench_vga's
# orbit, poses TUM_ORBIT_POSES of orbit_pose(i, 192, ...), at fr3_office's
# calibration: orbit poses 0..11 as frames 0..11, the tracked frames/s
# window, then every TUM_STRIDE-th pose, so that the first keyframe after
# frame 0 comes at orbit pose ~50 after half as many frames; until the
# Replica phase took their time every pose up to 88 was a frame, the
# keyframe came at frame 50, and the dp and thread phases ran on to the next
# one), the run's wall budget to that keyframe, the frames run after the
# resume; the EuRoC-layout stereo sequence (tools/run_fixture_evals.py's rig)
TUM_CONFIG = os.path.join(REPO, "configs", "rgbd", "tum", "fr3_office.yaml")
EUROC_CONFIG = os.path.join(REPO, "configs", "stereo", "euroc", "base_config.yaml")
TUM_STRIDE = 3
TUM_ORBIT_POSES = list(range(12)) + list(range(12, 88, TUM_STRIDE))
INGEST_FRAMES = len(TUM_ORBIT_POSES)
INGEST_BUDGET_S = 200.0
# 8 until the dp phase took their time, 3 until the replay phase's
RESUME_FRAMES = 2
# thread phase: the wall budget to a keyframe mapped on the backend thread
# while the frontend tracked on, from the TUM run's frame before its keyframe
THREAD_BUDGET_S = 200.0
# dp phase: TPU.mesh_devices in the resumed run (a one-device mesh on one
# card), its wall budget to the next keyframe's data-parallel mapping, the
# timing rounds of one full-width step and of the single path's iterations
DP_MESH_DEVICES = 2
DP_BUDGET_S = 200.0
DP_STEP_REPS, DP_SINGLE_ITERS = 2, 5
# tests/test_parallel.py's bounds between meshes: loss rtol, map first
# moment rtol/atol, poses and exposures atol, the slots' first moment atol
DP_LOSS_RTOL, DP_MU_RTOL, DP_MU_ATOL, DP_POSE_ATOL, DP_SLOT_MU_ATOL = 1e-5, 1e-4, 1e-7, 1e-6, 1e-7
# 24 EuRoC frames until the thread phase took their time: with 24, a host as
# slow as the slowest seen would near the 1,200 s limit (PERF.md section 7)
# 12 until the dp phase took their time; keyframes 0 and 7 either way; 8
# until the replay phase took their time, now that the fixture-eval tool's
# stereo row runs the EuRoC path for 100 frames outside this script:
# keyframe 0 only
EUROC_FRAMES, EUROC_SIZE = 3, (320, 240)
EUROC_TPU = {"capacity": 32768, "max_per_tile": 512, "k_dup": 8}
# replica phase: configs/rgbd/replica/office0_sp.yaml as committed on a
# Replica-layout sequence of the bench scene written on the card
# (REPLICA_FRAMES frames of orbit_pose(i, REPLICA_ORBIT_N, sweep 0.45), JPEG
# at image_io.JPEG_QUALITY), run to its first keyframe after frame 0 within
# REPLICA_BUDGET_S; the frames are the only cut. Round-trip PSNR bar of each
# decoded frame against its render (dB; the sound decode reads 45.5-45.6 dB,
# PERF.md section 2), and the crop of frame 0 that the plain entropy decoder
# (Python, ~64 s a 1200x680 frame on a CPU) checks
REPLICA_CONFIG = os.path.join(REPO, "configs", "rgbd", "replica", "office0_sp.yaml")
REPLICA_FRAMES, REPLICA_ORBIT_N = 8, 48  # the keyframe comes at frame 5
REPLICA_BUDGET_S = 240.0
REPLICA_PSNR_BAR = 40.0
PLAIN_CROP = (136, 240)
# replay phase: the first REPLAY_FRAMES frames of the fixture-eval tool's
# replay sequence (run_fixture_evals.run_replay: orbit_pose(i, REPLAY_ORBIT_N,
# sweep 0.4, ease_in) at 640x480): its first keyframe after frame 0 comes at
# frame 29 on the card (the window fills at frame 103, past this phase's
# time); and the run's wall budget
REPLAY_FRAMES, REPLAY_ORBIT_N = 40, 120
REPLAY_BUDGET_S = 150.0
# scale phase: configs/synthetic/scale_vga.yaml as committed, to its first
# keyframe after the initialization, then the growth path forced; the run's
# wall budget (the whole sweep runs in run_fixture_evals.py's scale row)
SCALE_CONFIG = os.path.join(REPO, "configs", "synthetic", "scale_vga.yaml")
SCALE_BUDGET_S = 240.0
STEREO_VALID_BAR, STEREO_REL_BAR = 0.15, 0.1  # tests/test_datasets.py:306-309
# CUDA runtime calls in which the host waits for the device (device-to-host
# copies of the stop tests' values, synchronizations)
HOST_WAIT_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize")
def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn` over `reps` calls, each between two CUDA
    events (for a wrapper: its host work included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def timed(fn):
    """(fn's result, its milliseconds between two CUDA events), one call:
    the plain versions of the lab, ~0.1 s a call, are timed by the call
    that checks against them."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def check_kernels(label, t_props, counts, tx_n, rcfg):
    """K1/K3/K2 against the plain blend and against their first version
    (t_final, n_done and touch counts equal bit for bit) on these per-tile
    props, then each timed: kernel-only beside the first version, in turns
    (`kernel_ms`), through its wrapper, and the plain version."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops.rasterize import tile_wh

    dev = t_props.device
    tw, th = tile_wh(rcfg)
    n_tiles = t_props.shape[0]
    cargs = (tx_n, (tw, th), rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    print(f"{label} kernels: props {tuple(t_props.shape)}, entries {int(counts.sum())}, "
          f"max per tile {int(counts.max())}, tiles over 256 entries "
          f"{int((counts > 256).sum())}", flush=True)

    results = {}
    with torch.no_grad():
        k1 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=False)
        k3 = B.blend_forward_cuda(t_props, counts, *cargs, emit_touch=True)
        launch_v1, v1 = B.forward_launcher(t_props, counts, *cargs, True, version=1)
        launch_v1()
        ref = B.blend_tiles_reference(t_props, counts, *cargs, tile_group=rcfg.tile_group)
    torch.cuda.synchronize()
    for name, out in (("K1", k1), ("K3", k3)):
        errs = {}
        for key, x, y in zip(("color", "depth", "alpha"), out[:3], ref[:3]):
            errs[key] = float((x - y).abs().max())
            if not errs[key] <= TOL[key]:
                fail(f"{label} {name} {key} max |err| {errs[key]} > {TOL[key]}")
        results[name] = {"max_abs_err": max(errs.values()), "errs": errs}
    n_bad = int((k3[5] != ref[3]).sum())
    if n_bad:
        fail(f"{label} K3 touch counts differ from the plain version in {n_bad} entries")
    for what, a, b in (("t_final", k1[3], v1[3]), ("n_done", k1[4], v1[4]),
                       ("touch", k3[5], v1[5])):
        if not torch.equal(a, b):
            fail(f"{label} {what} differs from the first version's in {int((a != b).sum())} "
                 "places")
    print(f"{label} K1 vs plain: {results['K1']['errs']} (tol {TOL}); "
          f"pixels past entry 256: {int((k1[4] > 256).sum())}", flush=True)
    print(f"{label} K3 vs plain: {results['K3']['errs']}, touch counts equal "
          f"({int((ref[3] > 0).sum())} touched entries); t_final, n_done and touch equal to "
          "the first version's", flush=True)
    n_mult, n_touch = int(k1[4].sum()), int(ref[3].sum())
    print(f"{label} pairs: {n_mult} (entry, pixel) pairs multiplied in, {n_touch} of them "
          f"({100.0 * n_touch / max(n_mult, 1):.2f}%) with alpha >= alpha_min", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    p = tw * th
    g_color = torch.randn((n_tiles, 3, p), generator=gen, device=dev)
    g_depth = 0.1 * torch.randn((n_tiles, p), generator=gen, device=dev)
    g_alpha = torch.randn((n_tiles, p), generator=gen, device=dev)
    pr = t_props.clone().requires_grad_(True)
    c_r, d_r, a_r, _ = B.blend_tiles_reference(pr, counts, *cargs, tile_group=rcfg.tile_group)
    plain_loss = (c_r * g_color).sum() + (d_r * g_depth).sum() + (a_r * g_alpha).sum()
    (g_ref,) = torch.autograd.grad(plain_loss, pr, retain_graph=True)
    t_final, n_done = k1[3], k1[4]
    bwd_args = (t_props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, (tw, th),
                rcfg.alpha_clamp, rcfg.alpha_min)
    g_k = B.blend_backward_cuda(*bwd_args)
    launch_v1, g_v1 = B.backward_launcher(*bwd_args, version=1)
    launch_v1()
    torch.cuda.synchronize()
    err = (g_k - g_ref).abs()
    bad = err > GRAD_ATOL + GRAD_RTOL * g_ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g_k).all()):
        fail(f"{label} K2 props gradient: {int(bad.sum())} of {bad.numel()} outside rtol "
             f"{GRAD_RTOL} atol {GRAD_ATOL} (max |err| {float(err.max())})")
    results["K2"] = {"max_abs_err": float(err.max())}
    err_v1 = (g_v1 - g_ref).abs()
    print(f"{label} K2 vs plain autograd: max |err| {float(err.max())} "
          f"(max |grad| {float(g_ref.abs().max())}; rtol {GRAD_RTOL}, atol {GRAD_ATOL}); first "
          f"version vs plain autograd: max |err| {float(err_v1.max())}, outside the same "
          f"tolerance {int((err_v1 > GRAD_ATOL + GRAD_RTOL * g_ref.abs()).sum())}", flush=True)

    with torch.no_grad():
        for name, touch in (("K1", False), ("K3", True)):
            ms = kernel_ms({v: B.forward_launcher(t_props, counts, *cargs, touch, version=v)[0]
                            for v in (2, 1)})
            results[name]["ms"], results[name]["ms_v1"] = ms[2], ms[1]
            results[name]["wrapper_ms"] = cuda_ms(
                lambda touch=touch: B.blend_forward_cuda(t_props, counts, *cargs, touch))
        ms = kernel_ms({v: B.backward_launcher(*bwd_args, version=v)[0] for v in (2, 1)})
        results["K2"]["ms"], results["K2"]["ms_v1"] = ms[2], ms[1]
        results["K2"]["wrapper_ms"] = cuda_ms(lambda: B.blend_backward_cuda(*bwd_args))
        plain_fwd = cuda_ms(lambda: B.blend_tiles_reference(
            t_props, counts, *cargs, tile_group=rcfg.tile_group), reps=5)
    results["K1"]["plain_ms"] = plain_fwd
    results["K3"]["plain_ms"] = plain_fwd  # the plain forward always counts touches
    results["K2"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(plain_loss, pr, retain_graph=True), reps=5)
    for name in ("K1", "K3", "K2"):
        r = results[name]
        r["bound_ms"], r["bound_by"] = bound(name, counts, k1[4], ref[3], p)
        print(f"{label} {name}: {r['ms']:.4f} ms kernel-only (first version {r['ms_v1']:.4f} "
              f"ms, {r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return results


def set_times(res) -> dict:
    """The numbers of one prop set for the `kernels` line."""
    return {k: res[k] for k in ("ms", "ms_v1", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}


def scene_kernel_phase(config, dev):
    """The kernels on the bench scene itself, seen from frame 0's pose."""
    import torch

    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.data.synthetic import SyntheticDataset
    from monogs_dev_tpu_torch.ops.rasterize import grid_dims, tile_wh
    from monogs_dev_tpu_torch.tools.kernel_lab import tile_props

    ds = SyntheticDataset(config, dev)
    T0 = torch.as_tensor(ds.poses[0], dtype=torch.float32, device=dev)
    rcfg = raster_config_from(config)
    t_props, counts = tile_props(ds.scene_params, ds.scene_active, T0, ds.intr, rcfg)
    return check_set("frame 0", t_props, counts, grid_dims(ds.intr, *tile_wh(rcfg))[0], rcfg,
                     lab_full=False)


def snapshot_map(slam, kf, name):
    """A copy of the map and of keyframe `kf`'s pose, for `map_kernel_phase`."""
    import torch

    engine = slam.engine
    return (f"{name} (kf {kf}, frame {slam.frontend.cur_frame_idx})",
            engine.gmap.params.map(lambda x: x.detach().clone()),
            engine.gmap.aux.active.clone(),
            torch.as_tensor(engine.viewpoints[kf].T_w2c, dtype=torch.float32,
                            device=slam.device))


def map_kernel_phase(snapshots, intr, rcfg, dilate):
    """The kernels on mapped maps, binned as the mapping loop bins them
    (tiles dilated by `mapping_rebin_dilation`): the density the mapping
    renders blend. L2 is held to autograd on every map but the TUM run's
    end map. Returns {label: check_set's results}."""
    from monogs_dev_tpu_torch.ops.rasterize import grid_dims, tile_wh
    from monogs_dev_tpu_torch.tools.kernel_lab import tile_props

    out = {}
    for label, params, active, T in snapshots:
        t_props, counts = tile_props(params, active, T, intr, rcfg, dilate=dilate)
        out[label] = check_set(label, t_props, counts, grid_dims(intr, *tile_wh(rcfg))[0], rcfg,
                               lab_full=" end map" not in label)
    return out


def _map_fields(gmap):
    for group, fields in (("params", gmap.params), ("aux", gmap.aux),
                          ("adam_mu", gmap.moments.mu), ("adam_nu", gmap.moments.nu)):
        for f in dataclasses.fields(fields):
            yield f"{group}.{f.name}", getattr(fields, f.name)


def tier_phase(slam):
    """The map tiers on the card. The TUM run's window never fills, so it
    neither compacts nor grows the map; this compacts its map after the
    first keyframe's mapping and prune to the smallest power-of-two tier
    that holds its alive rows and grows it back (`compact_map`,
    `resize_map`, as `BackendEngine`'s tiers call them). Every field must
    equal the same steps on a CPU copy, and the compacted map must render
    what the full map renders."""
    import torch

    from monogs_dev_tpu_torch.models.gaussians import compact_map, resize_map
    from monogs_dev_tpu_torch.ops.rasterize import render_tiled

    gmap, eng = slam.engine.gmap, slam.engine
    rows, alive = int(gmap.aux.active.shape[0]), int(gmap.aux.active.sum())
    tier = 1 << max(alive - 1, 1).bit_length()
    if tier >= rows:
        fail(f"tiers: {alive} alive rows leave no smaller tier than {rows}")
    small, perm = compact_map(gmap, tier)
    grown = resize_map(small, rows)
    small_cpu, perm_cpu = compact_map(gmap.rows(lambda x: x.cpu()), tier)
    grown_cpu = resize_map(small_cpu, rows)
    if not torch.equal(perm.cpu(), perm_cpu):
        fail("tiers: compact_map's row permutation differs from the CPU's")
    for label, card, cpu in (("compacted", small, small_cpu), ("grown", grown, grown_cpu)):
        for (name, a), (_, b) in zip(_map_fields(card), _map_fields(cpu)):
            if not torch.equal(a.cpu(), b):
                fail(f"tiers: {label} {name} differs from the CPU's")
    if int(small.aux.active.sum()) != alive or int(grown.aux.active[tier:].sum()) != 0:
        fail("tiers: alive rows lost or misplaced by compaction")

    kf = slam.frontend.kf_indices[-1]
    T = torch.as_tensor(eng.viewpoints[kf].T_w2c, dtype=torch.float32, device=slam.device)
    with torch.no_grad():
        full, comp = (render_tiled(m.params, m.aux.active, T, slam.intr, eng.cfg.sh_degree,
                                   config=slam.raster_cfg) for m in (gmap, small))
    errs = {k: float((getattr(full, k) - getattr(comp, k)).abs().max())
            for k in ("color", "depth", "alpha")}
    for k, v in errs.items():
        if not v <= TOL[k]:
            fail(f"tiers: the compacted map's {k} differs by {v} > {TOL[k]}")
    if not torch.equal(full.n_touched[perm[:tier]], comp.n_touched):
        fail("tiers: n_touched of the compacted map differs from the full map's")
    print(f"tiers: {rows} -> {tier} -> {rows} rows, {alive} alive, every field equal to "
          f"the CPU's; render of kf {kf} vs full map {errs}, n_touched equal "
          f"({int((comp.n_touched > 0).sum())} touched)", flush=True)


def check_lab(label, t_props, counts, tx_n, rcfg, full):
    """Every L1 variant and L2 against their plain versions on these props,
    and with `full` L2 also against autograd through the plain blend in
    float32 (K2's tolerances) and float64, where L2 may have no more entries
    outside tolerance than its first version (csrc/blend_lab_v1.cu). Each is
    timed: kernel-only beside its first version, in turns (`kernel_ms`),
    through its wrapper, and the plain version."""
    import torch

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import blend_lab as BL
    from monogs_dev_tpu_torch.ops.rasterize import tile_wh

    tw, th = tile_wh(rcfg)
    tile, p = (tw, th), tw * th
    cfg = (rcfg.alpha_clamp, rcfg.alpha_min, rcfg.transmittance_min)
    res = {}
    with torch.no_grad():
        t_final, n_done = BL.blend_residuals(t_props, counts, tx_n, tile, *cfg)
        touch = B.blend_tiles_reference(t_props, counts, tx_n, tile, *cfg,
                                        tile_group=rcfg.tile_group)[3]
        for v in BL.LAB_VARIANTS:
            out = BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg)
            launch_v1, out_v1 = BL.lab_forward_launcher(v, t_props, counts, tx_n, tile, *cfg,
                                                        version=1)
            launch_v1()
            ref, plain_ms = timed(lambda v=v: BL.lab_blend_reference(
                v, t_props, counts, tx_n, tile, *cfg, rcfg.tile_group))
            errs, errs_v1 = ({k: float((a - b).abs().max()) for k, a, b in
                              zip(("color", "depth", "alpha"), o, ref)} for o in (out, out_v1))
            for k, e in errs.items():
                if not e <= TOL[k]:
                    fail(f"{label} L1/{v} {k} max |err| {e} > {TOL[k]}")
            r = res[f"L1/{v}"] = {"max_abs_err": max(errs.values()), "errs": errs}
            ms = kernel_ms({ver: BL.lab_forward_launcher(v, t_props, counts, tx_n, tile, *cfg,
                                                         version=ver)[0] for ver in (2, 1)})
            r["ms"], r["ms_v1"] = ms[2], ms[1]
            r["wrapper_ms"] = cuda_ms(
                lambda v=v: BL.lab_forward_cuda(v, t_props, counts, tx_n, tile, *cfg))
            r["plain_ms"] = plain_ms
            r["bound_ms"], r["bound_by"] = bound(f"L1/{v}", counts, n_done, touch, p)
            print(f"{label} L1/{v} vs plain: {errs} (first version {errs_v1}); {r['ms']:.4f} ms "
                  f"kernel-only (first version {r['ms_v1']:.4f} ms, "
                  f"{r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                  flush=True)

        gen = torch.Generator(device=t_props.device).manual_seed(1)
        cots = (torch.randn((t_props.shape[0], 3, p), generator=gen, device=t_props.device),
                0.1 * torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device),
                torch.randn((t_props.shape[0], p), generator=gen, device=t_props.device))
        args = (t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
        got = BL.moments_backward_cuda(*args)
        launch_v1, got_v1 = BL.moments_launcher(*args, version=1)
        launch_v1()
        plain, plain_ms = timed(lambda: BL.moments_backward_reference(*args, rcfg.tile_group))
    if not bool(torch.isfinite(got).all()):
        fail(f"{label} L2: non-finite gradient")
    refs = {"plain": plain}
    if full:
        # the gradient references: autograd through the plain blend in
        # float32 (what K2 is held to) and in float64
        for dtype in (torch.float64, torch.float32):
            pr = t_props.to(dtype).requires_grad_(True)
            out = B.blend_tiles_reference(pr, counts, tx_n, tile, *cfg,
                                          tile_group=rcfg.tile_group)
            (g,) = torch.autograd.grad(sum((o * c.to(dtype)).sum() for o, c in zip(out[:3], cots)),
                                       pr)
            refs[str(dtype)[6:] + " autograd"] = g
            del pr, out
        with torch.no_grad():
            k2 = B.blend_backward_cuda(t_props, t_final, n_done, *cots, tx_n, tile, *cfg[:2])
        torch.cuda.synchronize()
    errs, n_bad = {}, {}
    checks = [("L2", got, name, ref) for name, ref in refs.items()]
    if full:
        checks += [("L2 first version", got_v1, "float64 autograd", refs["float64 autograd"]),
                   ("K2", k2, "float64 autograd", refs["float64 autograd"]),
                   ("float32 autograd", refs["float32 autograd"], "float64 autograd",
                    refs["float64 autograd"])]
    for who, x, name, ref in checks:
        what = f"{who} vs {name}"
        x, ref = x.to(torch.float64), ref.to(torch.float64)
        err = (x - ref).abs()
        ratio = err / (GRAD_ATOL + GRAD_RTOL * ref.abs())
        atol = L2_ATOL_REL * float(ref.abs().max())
        n_bad[what] = int((err > atol + GRAD_RTOL * ref.abs()).sum())
        errs[what] = float(err.max())
        t_i, e_i, c_i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
        print(f"{label} {what}: max |err| {errs[what]:.4g}; worst entry against K2's "
              f"tolerance (rtol {GRAD_RTOL}, atol {GRAD_ATOL}): tile {t_i} entry {e_i} column "
              f"{c_i}, err {float(err[t_i, e_i, c_i]):.4g} on {float(ref[t_i, e_i, c_i]):.6g} "
              f"({float(ratio.max()):.3g} x tol; mean {t_props[t_i, e_i, 0:2].tolist()}, conic "
              f"{t_props[t_i, e_i, 2:5].tolist()}), {int((ratio > 1.0).sum())} of "
              f"{ratio.numel()} outside it; outside rtol {GRAD_RTOL} atol {atol:.3g} "
              f"({L2_ATOL_REL} x max |grad| {float(ref.abs().max()):.4g}): {n_bad[what]}",
              flush=True)
    held = ["L2 vs plain"] + (["L2 vs float32 autograd"] if full else [])
    for what in held:
        if n_bad[what]:
            fail(f"{label} {what}: {n_bad[what]} entries outside tolerance")
    if full and n_bad["L2 vs float64 autograd"] > n_bad["L2 first version vs float64 autograd"]:
        fail(f"{label} L2: {n_bad['L2 vs float64 autograd']} entries outside tolerance against "
             f"float64 autograd, more than the first version's "
             f"{n_bad['L2 first version vs float64 autograd']}")
    r = res["L2"] = {"max_abs_err": max(errs[k] for k in held)}
    with torch.no_grad():
        ms = kernel_ms({ver: BL.moments_launcher(*args, version=ver)[0] for ver in (2, 1)})
        r["ms"], r["ms_v1"] = ms[2], ms[1]
        r["wrapper_ms"] = cuda_ms(lambda: BL.moments_backward_cuda(*args))
        r["plain_ms"] = plain_ms
    r["bound_ms"], r["bound_by"] = bound("L2", counts, n_done, touch, p)
    print(f"{label} L2: {r['ms']:.4f} ms kernel-only (first version {r['ms_v1']:.4f} ms, "
          f"{r['ms_v1'] / r['ms']:.2f}x), wrapper {r['wrapper_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return res


def check_set(label, t_props, counts, tx_n, rcfg, lab_full):
    """K1-K3 (`check_kernels`) and L1/L2 (`check_lab`) on one prop set."""
    return (check_kernels(label, t_props, counts, tx_n, rcfg),
            check_lab(label, t_props, counts, tx_n, rcfg, lab_full))


def lab_phase(dev):
    """The lab's entry point on the lab scene (the launch counts of that
    run), then K1-K3 and L1/L2 (`check_set`) on the lab scene. Returns (L1/L2
    launches, the lab scene's check_set results)."""
    import torch

    from monogs_dev_tpu_torch.data.synthetic import load_lab_scene
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import blend_lab as BL
    from monogs_dev_tpu_torch.tools import kernel_lab as KL

    B.reset_launch_counts()
    for v in BL.VARIANT_LAUNCHES:
        BL.VARIANT_LAUNCHES[v] = 0
    KL.run_lab(KL.ALL_VARIANTS, dev)
    torch.cuda.synchronize()
    launches = {f"L1/{v}": n for v, n in BL.VARIANT_LAUNCHES.items()}
    launches["L2"] = B.LAUNCHES["L2"]
    print(f"lab launches: {launches} (K1 {B.LAUNCHES['K1']}, K2 {B.LAUNCHES['K2']})", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the lab's run")

    params = load_lab_scene(dev)
    active = torch.ones(params.xyz.shape[0], dtype=torch.bool, device=dev)
    t_props, counts = KL.tile_props(params, active, torch.eye(4, device=dev), KL.LAB_INTR,
                                    KL.LAB_RASTER)
    tx_n = -(-KL.LAB_INTR.width // KL.LAB_RASTER.tile)
    print(f"lab scene: props {tuple(t_props.shape)}, entries {int(counts.sum())}, "
          f"max per tile {int(counts.max())}", flush=True)
    return launches, check_set("lab", t_props, counts, tx_n, KL.LAB_RASTER, lab_full=True)


def profile_frames(label, slam, start: int, n: int, frame_ms: float):
    """`torch.profiler` over frames [start, start + n) of the run, after its
    timed window: each K kernel's device ms per frame, the device's summed
    kernel time per frame and its idle share, of the profiled wall time (the
    profiler slows the host) and of `frame_ms`, the unprofiled frame time
    of the timed window, and the host's blocking reads of the device
    (HOST_WAIT_CALLS) per frame. None where the trace holds no device time.
    No other thread that Python started may be alive: with the backend
    thread running its mapping backward beside the profiled frame's, the
    process died of SIGSEGV in native code (1 of 3 runs in one call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    others = started_threads()
    if others:
        fail(f"{label} profile: threads {others} run beside the profiled frames")

    torch.cuda.synchronize()
    t0 = time.time()
    # the CUDA activity alone (the kernels, copies and runtime calls): the
    # aten ops' records would double the profiled host time and the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        slam.frontend.run(max_frames=start + n)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0) / n
    averages = prof.key_averages()
    # the device's rows (the runtime calls are host rows)
    rows = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    if busy_ms <= 0.0:
        print("profile: the trace holds no device time (not measured)", flush=True)
        return None
    # the host's reads of device values: CUDA runtime calls that block until
    # the device has drained its queue (under the profiler's slower host)
    waits = [e for e in averages if e.key in HOST_WAIT_CALLS]
    out = {
        "frames": [start, start + n],
        "kernel_ms_per_frame": {k: sum(e.self_device_time_total for e in rows if pat in e.key)
                                / 1e3 / n for k, pat in PROFILE_NAMES.items()},
        "host_wait_per_frame": {e.key: {"calls": e.count / n, "ms": e.cpu_time_total / 1e3 / n}
                                for e in waits},
        "device_ms_per_frame": busy_ms,
        "profiled_wall_ms_per_frame": wall_ms,
        "idle_share_profiled": 1.0 - busy_ms / wall_ms,
        "timed_window_ms_per_frame": frame_ms,
        "idle_share_of_timed_frame": 1.0 - busy_ms / frame_ms,
        "top": [(e.key[:80], e.self_device_time_total / 1e3 / n)
                for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]],
    }
    print(f"{label} profile: " + json.dumps(out), flush=True)
    return out


def mono_phase(config, dev):
    """bench_torch.py's run: bench_vga forced monocular, warm-up until both
    halves are initialized (by frame MONO_FRAME_CAP), MONO_MEAS timed frames; a
    copy of the map at initialization (for `map_kernel_phase`); then
    PROFILE_FRAMES more frames under the profiler."""
    import torch

    import bench_torch
    from monogs_dev_tpu_torch.ops import blend as B

    snapshot = []

    def at_init(slam):
        snapshot.append(snapshot_map(slam, slam.frontend.kf_indices[-1], "mono init map"))

    B.reset_launch_counts()
    slam, info = bench_torch.run_bench(config, dev, n_meas=MONO_MEAS, at_init=at_init)
    torch.cuda.synchronize()
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    fe = slam.frontend
    ate = slam.keyframe_ate()
    info.update(keyframes=list(fe.kf_indices), frames=len(fe.cameras),
                keyframe_ate_cm=100.0 * ate, alive=slam.n_alive(), launches=launches,
                timers=slam.timers.summary(), telemetry=slam.engine.telemetry)
    print("mono: " + json.dumps(info), flush=True)
    print(f"mono frames/s: {info['fps']:.4f} over frames [{info['warm_frames']}, "
          f"{info['warm_frames'] + MONO_MEAS})", flush=True)
    if not info["initialized"] or info["warm_frames"] > MONO_FRAME_CAP:
        fail(f"the monocular run did not initialize by frame {MONO_FRAME_CAP}")
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras):
        fail("non-finite pose in the monocular run")
    if len(fe.kf_indices) < fe.window_size:
        fail(f"{len(fe.kf_indices)} keyframes, fewer than the window's {fe.window_size}")
    if not (np.isfinite(ate) and ate < MONO_ATE_BAR):
        fail(f"monocular keyframe ATE {ate} m is not finite and under {MONO_ATE_BAR} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched in the monocular run")
    start = info["warm_frames"] + MONO_MEAS
    n = min(PROFILE_FRAMES, len(slam.dataset) - start)
    info["profile"] = profile_frames("mono", slam, start, n, 1e3 / info["fps"]) if n > 0 else None
    return info, snapshot[0], slam.intr, slam.raster_cfg, slam.step_cfg.mapping_rebin_dilation


class TrackRecorder:
    """Stands in for the frontend's Adam tracker (`core/frontend.py`'s
    `track_frame`): records each frame's iteration count and convergence,
    and the inputs of frame `keep` (for `gradient_check`)."""

    def __init__(self, frontend, keep: int):
        from monogs_dev_tpu_torch.core import tracking

        self.track_frame = tracking.track_frame
        self.frontend, self.keep = frontend, keep
        self.iters, self.converged, self.inputs = {}, {}, None

    def __call__(self, *args, **kwargs):
        idx = self.frontend.cur_frame_idx
        if idx == self.keep:
            self.inputs = (args, kwargs)
        res = self.track_frame(*args, **kwargs)
        self.iters[idx], self.converged[idx] = res.n_iters, res.converged
        return res


def gradient_check(inputs):
    """The Adam tracker's first iteration on one frame of the run (its map,
    start pose, image and real edge mask): loss and (tau, exposure) gradient
    through K1/K2 against the same through the plain blend on the card."""
    import torch

    from monogs_dev_tpu_torch.core import tracking as tt
    from monogs_dev_tpu_torch.ops import rasterize as R
    from monogs_dev_tpu_torch.ops.blend import blend_tiles_reference
    from monogs_dev_tpu_torch.utils.losses import compute_grad_mask

    (params, active, T_init, exp0, image, depth, _, bg, cfg, intr, rcfg), kw = inputs
    dev = image.device
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    mask = compute_grad_mask(image, cfg.edge_threshold, cfg.per_block_mask)
    tile_mask = tt.tile_mask_of(mask, intr, rcfg)
    with torch.no_grad():
        proj = R.project_gaussians(params, active, T, intr, cfg.sh_degree)
        binning = R.build_binning(proj, intr, rcfg, dilate=cfg.rebin_dilation)
    args = (T, torch.as_tensor(exp0, dtype=torch.float32, device=dev), params, active, binning,
            image, depth, mask, tile_mask, bg, cfg, intr, rcfg, kw["use_depth"])
    loss_k, g_k = tt.pose_gradient(*args)
    kernel_blend = R.blend_tiles
    R.blend_tiles = lambda *a: blend_tiles_reference(*a)[:3]
    try:
        loss_p, g_p = tt.pose_gradient(*args)
    finally:
        R.blend_tiles = kernel_blend
    loss_k, loss_p = float(loss_k), float(loss_p)
    g_err = float((g_k - g_p).abs().max())
    g_max = float(g_p.abs().max())
    out = {"tiles_blended": int(tile_mask.sum()), "tiles": int(tile_mask.numel()),
           "loss_kernels": loss_k, "loss_plain": loss_p, "grad_kernels": g_k.tolist(),
           "grad_plain": g_p.tolist(), "grad_max_abs_err": g_err, "grad_max_abs": g_max}
    print("parity gradient check: " + json.dumps(out), flush=True)
    if not (tile_mask.any() and not tile_mask.all()):
        fail("parity gradient check: the edge mask leaves no tile masked out (or none in)")
    if not (np.isfinite(g_err) and g_err <= GRAD_CHECK_REL * g_max and g_max > 0.0):
        fail(f"parity gradient check: max |g_kernels - g_plain| {g_err} > {GRAD_CHECK_REL} x "
             f"max |g| {g_max}")
    if not abs(loss_k - loss_p) <= LOSS_CHECK_REL * abs(loss_p):
        fail(f"parity gradient check: loss {loss_k} (kernels) vs {loss_p} (plain)")
    return out


def projection_check(inputs):
    """The projection's kernels on the Adam tracker's frame of the parity
    run (its map and start pose): P1 against the eager composition, P2
    against `project_pose_vjp_plain` on seeded upstream gradients; P1 and
    P2 timed kernel-only (`kernel_ms`), through the wrapper and as their
    plain versions, beside their bound (the bytes they must move over
    3.35 TB/s); then the tracker's frame again: P1 and P2 launched, and no
    projection took the eager path."""
    import torch

    from monogs_dev_tpu_torch.core import tracking as tt
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops import project as P
    from monogs_dev_tpu_torch.ops.blend_timing import HBM_BPS, kernel_ms
    from monogs_dev_tpu_torch.utils import profiling

    args, kw = inputs
    params, active, T_init, intr = args[0], args[1], args[2], args[9]
    dev = params.xyz.device
    T = torch.as_tensor(T_init, dtype=torch.float32, device=dev)
    n = params.xyz.shape[0]
    with torch.no_grad():
        out = P.project_gaussians_cuda(params, active, T, intr)
        ref = P.project_gaussians_eager(params, active, T, intr, 0)
    if not (torch.equal(out.radii, ref.radii) and torch.equal(out.valid, ref.valid)):
        fail("projection: P1's radii or valid differ from the eager composition's")
    rel = {f: float(((getattr(out, f) - getattr(ref, f)).abs()
                     / getattr(ref, f).abs().clamp(min=1e-30)).max())
           for f in ("means2d", "conic", "color", "opacity", "depth")}
    if not all(v <= PROJ_REL for v in rel.values()):
        fail(f"projection: P1 against the eager composition, relative {rel} > {PROJ_REL}")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = (torch.randn((n, 2), generator=gen, device=dev),
         1e-3 * torch.randn((n, 3), generator=gen, device=dev),
         torch.randn((n,), generator=gen, device=dev))
    fields = (T, params.xyz, params.log_scales, params.quats, params.opacity_logit, params.f_dc,
              params.f_rest)
    fwd, _ = P.project_fwd_launcher(*fields, active, intr)
    bwd, dT = P.project_bwd_launcher(*fields, *g, intr)
    bwd()
    plain = P.project_pose_vjp_plain(params, T, intr, *g)
    g_err = float((dT - plain).abs().max()) / float(plain.abs().max())
    if not g_err <= POSE_GRAD_REL:
        fail(f"projection: P2 against the plain version, {g_err} > {POSE_GRAD_REL}")
    ms = kernel_ms({"P1": fwd, "P2": bwd})
    with torch.no_grad():
        wrapper_ms = cuda_ms(lambda: P.project_gaussians(params, active, T, intr, 0))
        plain_ms = cuda_ms(lambda: P.project_gaussians_eager(params, active, T, intr, 0))
        plain_vjp_ms = cuda_ms(lambda: P.project_pose_vjp_plain(params, T, intr, *g))
    rest = 4 * params.f_rest[0].numel()
    row_in = 12 + 12 + 16 + 4 + 12 + rest  # xyz, log-scales, quaternion, opacity, f_dc, f_rest
    blocks = -(-n // P.THREADS)
    bytes_p1 = n * (row_in + 1 + 8 + 12 + 12 + 4 + 4 + 4 + 1) + 64
    bytes_p2 = n * (row_in + 8 + 12 + 4) + 2 * 96 * blocks + 64 + 64
    rows = {}
    for name, nbytes, plain_t in (("P1", bytes_p1, plain_ms), ("P2", bytes_p2, plain_vjp_ms)):
        bound_ms = 1e3 * nbytes / HBM_BPS
        rows[name] = {"ms": ms[name], "bound_ms": bound_ms, "bound_by": "bytes",
                      "gap": ms[name] / bound_ms, "plain_ms": plain_t}
    rows["P1"]["wrapper_ms"] = wrapper_ms

    timers, before = profiling.PhaseTimers(), profiling.active()
    profiling.activate(timers)
    launches = dict(B.LAUNCHES)
    try:
        res = tt.track_frame(*args, **kw)
        torch.cuda.synchronize()
    finally:
        profiling.activate(before)
    launched = {k: B.LAUNCHES[k] - launches[k] for k in ("P1", "P2", "K1", "K2")}
    paths = {k: timers.tallies[k] for k in ("project.kernel", "project.eager")}
    info = {"rows": n, "active": int(active.sum()), "valid": int(ref.valid.sum()),
            "p1_rel_err": rel, "p2_rel_err": g_err, "kernels": rows,
            "track_frame": {"iters": res.n_iters, "launches": launched, "paths": paths}}
    print("projection: " + json.dumps(info), flush=True)
    if paths["project.eager"] or not paths["project.kernel"]:
        fail(f"projection: the Adam tracker's frame took the eager projection: {paths}")
    if launched["P2"] != res.n_iters or launched["P1"] < res.n_iters:
        fail(f"projection: P1/P2 launches {launched} for {res.n_iters} Adam iterations")
    return info


def parity_phase(dev):
    """`configs/synthetic/bench_vga_parity.yaml` (RGB-D, the reference's
    Adam tracking loop) through `SLAM`, the code path of `slam_torch.py
    --eval`: frame 0's init mapping and frames 1..11 (frames 2..11 give the
    tracked frames/s), then PARITY_PROFILE_FRAMES profiled frames, then
    `SLAM.evaluate` (colour refinement, PSNR/SSIM/LPIPS before and after,
    ATE and PLY artifacts) into a temporary directory. Returns its info."""
    import tempfile

    import torch

    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.utils.config import load_config

    t_phase = time.time()
    config = load_config(PARITY_CONFIG)
    save_dir = tempfile.mkdtemp(prefix="parity_eval_")
    slam = SLAM(config, dev, seed=0, save_dir=save_dir)
    fe = slam.frontend
    for i in range(min(N_FRAMES + PARITY_PROFILE_FRAMES, len(slam.dataset))):
        slam.dataset.render_frame(i)  # outside the counted run
    recorder = TrackRecorder(fe, PARITY_GRAD_FRAME)
    frontend_mod.track_frame = recorder
    try:
        torch.cuda.synchronize()
        B.reset_launch_counts()
        t0 = time.time()
        slam.run(max_frames=1)  # frame 0 and its init mapping
        slam.run(max_frames=2)
        torch.cuda.synchronize()
        t1 = time.time()
        slam.run(max_frames=N_FRAMES)
        torch.cuda.synchronize()
        t2 = time.time()
        n = N_FRAMES
        launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3", "P1", "P2")}
        frame_ms = 1e3 * (t2 - t1) / (N_FRAMES - 2)
        profile = profile_frames("parity", slam, n, PARITY_PROFILE_FRAMES, frame_ms)
        profile_s = time.time() - t2
    finally:
        frontend_mod.track_frame = recorder.track_frame
    frames = sorted(fe.cameras)
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in frames):
        fail("non-finite pose in the parity run")
    ate = slam.keyframe_ate()
    ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [fe.cameras[i].T_gt for i in frames])
    iters = [recorder.iters[i] for i in sorted(recorder.iters) if i < n]  # the counted run
    info = {
        "frames_run": n,
        "init_and_first_frame_s": t1 - t0,
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "profile_s": profile_s,
        "adam_iters_mean": float(np.mean(iters)),
        "adam_iters_max": int(max(iters)),
        "frames_tracked": len(iters),
        "frames_converged": int(sum(recorder.converged[i] for i in recorder.converged if i < n)),
        "launches": launches,
        "k2_launches_per_tracked_frame": launches["K2"] / len(iters),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "keyframe_ate_cm": 100.0 * ate,
        "all_frame_ate_cm": 100.0 * ate_all,
        "timers": slam.timers.summary(),
        "telemetry": slam.engine.telemetry,
        "profile": profile,
    }
    print("parity: " + json.dumps(info), flush=True)
    for name, v in (("keyframe", ate), ("all-frame", ate_all)):
        if not (np.isfinite(v) and v < RGBD_ATE_BAR):
            fail(f"parity {name} ATE {v} m is not finite and under {RGBD_ATE_BAR} m")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the parity run")

    info["gradient_check"] = gradient_check(recorder.inputs)
    info["projection"] = projection_check(recorder.inputs)

    B.reset_launch_counts()
    t4 = time.time()
    results = slam.evaluate()
    torch.cuda.synchronize()
    info["eval_s"] = time.time() - t4
    info["eval_launches"] = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    info["eval"] = results
    for tag in ("before_opt", "after_opt"):
        r = results[tag]
        print(f"parity eval {tag}: PSNR {r['mean_psnr']:.4f} dB, SSIM {r['mean_ssim']:.5f}, "
              f"LPIPS {r.get('mean_lpips_noncanonical', r['mean_lpips'])} "
              f"({r['lpips_backend']}) over {r['n_frames']} frames", flush=True)
        if not (np.isfinite(r["mean_psnr"]) and np.isfinite(r["mean_ssim"]) and r["n_frames"]):
            fail(f"parity eval {tag}: PSNR/SSIM not finite or no frame rendered")
    for rel in ("trj_final.json", "plot/stats_final.json", "psnr/before_opt/final_result.json",
                "psnr/after_opt/final_result.json", "point_cloud/final/point_cloud.ply",
                "metrics.jsonl"):
        if not os.path.exists(os.path.join(save_dir, rel)):
            fail(f"parity eval did not write {rel}")
    shutil.rmtree(save_dir)
    info["phase_s"] = time.time() - t_phase
    print(f"parity: tracked frames/s {info['tracked_fps']:.4f}; Adam iterations a frame mean "
          f"{info['adam_iters_mean']:.2f}, max {info['adam_iters_max']}, converged "
          f"{info['frames_converged']} of {info['frames_tracked']}; launches {launches} "
          f"(eval {info['eval_launches']}); keyframe ATE {info['keyframe_ate_cm']:.4f} cm, "
          f"all-frame ATE {info['all_frame_ate_cm']:.4f} cm; eval {info['eval_s']:.1f} s; "
          f"phase {info['phase_s']:.1f} s", flush=True)
    return info


def slice_phase(config, dev):
    """Frames 0..11: the init mapping and the tracked frames/s (frames
    2..11). The keyframe path past frame 11 (insertion, kNN, windowed
    mapping, harvest) runs in the parity phase, RGB-D too. A copy of the
    map after the init mapping is returned for `map_kernel_phase`."""
    import torch

    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B

    slam = SLAM(config, dev, seed=0)
    fe = slam.frontend
    B.reset_launch_counts()
    t0 = time.time()
    slam.run(max_frames=1)  # frame 0 and, as the run ends, its init mapping
    snapshots = [snapshot_map(slam, 0, "RGB-D post-init map")]
    slam.run(max_frames=2)  # the first tracked frame
    torch.cuda.synchronize()
    t1 = time.time()
    slam.run(max_frames=N_FRAMES)
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    slam.stop()
    frames = sorted(fe.cameras)
    ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [fe.cameras[i].T_gt for i in frames])
    info = {
        "frames": N_FRAMES,
        "init_and_first_frame_s": round(t1 - t0, 3),
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "capacity_tier": int(slam.engine.gmap.aux.active.shape[0]),
        "all_frame_ate_cm": 100.0 * ate_all,
        "launches": launches,
        "timers": slam.timers.summary(),
        "telemetry": slam.engine.telemetry,
    }
    print("slice: " + json.dumps(info), flush=True)
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras):
        fail("non-finite pose in the slice")
    if not (np.isfinite(ate_all) and ate_all < RGBD_ATE_BAR):
        fail(f"all-frame ATE {ate_all} m is not finite and under {RGBD_ATE_BAR} m")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched in frames 0..11 of the slice")
    return slam, launches, snapshots


def _frame_ms(timers, name):
    entry = timers.summary().get(name)
    return entry["mean_ms"] if entry else None


def started_threads():
    """Names of the live threads that Python code started, the main thread
    apart. Threads that torch started in C++ and that ran Python (autograd's
    device threads run the blend's backward) show as `_DummyThread`s."""
    return [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not isinstance(t, threading._DummyThread)]


def assert_loader_never_waits(label, frontend, frames):
    """The frontend's frame fetch (decode into pinned memory, the copy to
    the card, the loader's arithmetic, for stereo the rectification and the
    matcher) under torch's sync debug mode set to raise: the host must
    never wait for the device there. The mode is the process's: no other
    thread may run while it is on."""
    import torch

    others = started_threads()
    if others:
        fail(f"{label}: threads {others} run while sync debug mode would be on")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in frames:
            frontend._fetch_frame(i)
    except RuntimeError as e:
        fail(f"{label}: the frame fetch waits for the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{label}: frames {list(frames)} fetched with no host wait (sync debug mode)",
          flush=True)


def paeth_row_share(seq):
    """The share of Paeth-filtered rows in a TUM-layout sequence's first
    colour and depth PNGs."""
    from monogs_dev_tpu_torch.data import image_io

    types = []
    for sub in ("rgb", "depth"):
        d = os.path.join(seq, sub)
        with open(os.path.join(d, sorted(os.listdir(d))[0]), "rb") as f:
            info, raw = image_io.parse_png(f.read())
        types.append(np.frombuffer(raw, np.uint8).reshape(info.height, -1)[:, 0])
    return float(np.mean(np.concatenate(types) == 4))


def tum_ingest(dev, tmp):
    """(a)-(c): the TUM-layout sequence, the fr3_office run through the TUM
    loader, the checkpoint and the resumed run. Returns (info, launches,
    the map after the first keyframe for `map_kernel_phase`)."""
    import torch

    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.tools import make_fixtures as mf
    from monogs_dev_tpu_torch.utils.checkpoint import load_map
    from monogs_dev_tpu_torch.utils.config import load_config

    config = load_config(TUM_CONFIG)
    cal = config["Dataset"]["Calibration"]
    intr = Intrinsics(fx=float(cal["fx"]), fy=float(cal["fy"]), cx=float(cal["cx"]),
                      cy=float(cal["cy"]), width=int(cal["width"]), height=int(cal["height"]))
    seq = os.path.join(tmp, "tum_vga")
    t0 = time.time()
    params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n8000.npz"), dev)
    orbit = mf.orbit(TUM_ORBIT_POSES[-1] + 1, n=192, sweep=0.45, ease=True, profile="ease_in")
    mf.write_tum(seq, params, active, intr, [orbit[i] for i in TUM_ORBIT_POSES],
                 depth_scale=float(cal["depth_scale"]))
    torch.cuda.synchronize()
    write_s = time.time() - t0
    del params, active
    paeth = paeth_row_share(seq)
    if paeth < 1.0:  # the reader's costly branch, as on PIL-written and TUM's files
        fail(f"tum: only {paeth} of the sequence's PNG rows are Paeth-filtered")
    config["Dataset"]["dataset_path"] = seq
    config["Results"]["save_results"] = False

    slam = SLAM(config, dev, seed=0)
    fe = slam.frontend
    recorder = TrackRecorder(fe, -1)
    frontend_mod.track_frame = recorder
    try:
        torch.cuda.synchronize()
        B.reset_launch_counts()
        t0 = time.time()
        slam.run(max_frames=2)  # frame 0, its init mapping, frame 1
        torch.cuda.synchronize()
        t1 = time.time()
        slam.run(max_frames=N_FRAMES)
        torch.cuda.synchronize()
        t2 = time.time()
        n = N_FRAMES
        last = INGEST_FRAMES - RESUME_FRAMES
        # the state after each frame before the keyframe, two files in turn
        # (for `thread_phase`'s run to a keyframe); the saves are not timed
        saved, save_s = {}, 0.0
        while len(fe.kf_indices) < 2 and n < last and time.time() - t0 < INGEST_BUDGET_S:
            n += 1
            slam.run(max_frames=n)  # ends with the keyframe's mapping pumped
            if len(fe.kf_indices) < 2:
                t_save = time.time()
                saved[n] = os.path.join(tmp, f"before_keyframe.{n % 2}.npz")
                slam.save_checkpoint(saved[n])
                save_s += time.time() - t_save
        torch.cuda.synchronize()
        t3 = time.time()
    finally:
        frontend_mod.track_frame = recorder.track_frame
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    frames = sorted(fe.cameras)
    if len(fe.kf_indices) < 2:
        fail(f"tum: no keyframe after frame 0 by frame {n} ({INGEST_BUDGET_S} s budget)")
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in frames):
        fail("tum: non-finite pose")
    ate = slam.keyframe_ate()
    iters = [recorder.iters[i] for i in sorted(recorder.iters)]
    snapshot = snapshot_map(slam, fe.kf_indices[-1], "TUM VGA end map")
    tier_phase(slam)

    # (c) checkpoint after the keyframe's mapping, load_map, resume
    path = os.path.join(tmp, "checkpoint.npz")
    torch.cuda.synchronize()
    t4 = time.time()
    slam.save_checkpoint(path)
    save_ms = 1e3 * (time.time() - t4)
    loaded, host = load_map(path, dev)
    for (name, a), (_, b) in zip(_map_fields(slam.engine.gmap), _map_fields(loaded)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"tum: load_map's {name} differs from the saved map")
    if loaded.moments.count != slam.engine.gmap.moments.count or \
            host["kf_ids"] != sorted(slam.engine.viewpoints):
        fail("tum: load_map's Adam step or keyframes differ from the saved run's")
    info = {
        "frames_run": n,
        "sequence_frames": INGEST_FRAMES,
        "write_s": write_s,
        "paeth_row_share": paeth,
        "init_and_first_frame_s": t1 - t0,
        "tracked_fps": (N_FRAMES - 2) / (t2 - t1),
        "frames_12_on_s": t3 - t2 - save_s,
        "adam_iters_mean": float(np.mean(iters)),
        "adam_iters_max": int(max(iters)),
        "launches": dict(launches),
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "map_rows": int(slam.engine.gmap.aux.active.shape[0]),
        "keyframe_ate_cm": 100.0 * ate,
        "loader_ms_per_frame": _frame_ms(slam.timers, "fetch_frame"),
        "tracking_ms_per_frame": _frame_ms(slam.timers, "tracking"),
        "checkpoint_bytes": os.path.getsize(path),
        "save_ms": save_ms,
        "timers": slam.timers.summary(),
    }
    assert_loader_never_waits("tum", fe, range(3))
    slam.stop()
    del slam, fe, loaded

    resumed = SLAM(config, dev, seed=0)
    B.reset_launch_counts()
    torch.cuda.synchronize()
    t5 = time.time()
    next_frame = resumed.resume(path)
    torch.cuda.synchronize()
    info["resume_ms"] = 1e3 * (time.time() - t5)
    t6 = time.time()
    resumed.run(max_frames=next_frame + RESUME_FRAMES)
    torch.cuda.synchronize()
    rfe = resumed.frontend
    info["resumed_frames"] = [next_frame, next_frame + RESUME_FRAMES]
    info["resumed_fps"] = RESUME_FRAMES / (time.time() - t6)
    info["resumed_keyframes"] = list(rfe.kf_indices)
    info["resumed_keyframe_ate_cm"] = 100.0 * resumed.keyframe_ate()
    for k in launches:
        launches[k] += B.LAUNCHES[k]
    info["launches_with_resume"] = launches
    resumed.stop()
    if n - 1 not in saved:
        fail(f"tum: the keyframe came at frame {n}, before any state was saved for the "
             f"thread phase")
    dp = dp_phase(config, dev, path, next_frame, info["resumed_fps"], saved[n - 1])
    thread = thread_phase(config, dev, path, next_frame, tmp, info["resumed_fps"],
                          saved[n - 1])
    print("tum: " + json.dumps(info), flush=True)
    if len(info["keyframes"]) < 2 or not info["keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"tum: keyframe ATE {info['keyframe_ate_cm']} cm over {info['keyframes']}: "
             f"needs 2 keyframes and under {100.0 * RGBD_ATE_BAR} cm")
    if not all(np.isfinite(rfe.cameras[i].T_est).all() for i in rfe.cameras) or \
            max(rfe.cameras) != next_frame + RESUME_FRAMES - 1:
        fail("tum: the resumed run's frames are not all there and finite")
    if not info["resumed_keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"tum: resumed keyframe ATE {info['resumed_keyframe_ate_cm']} cm")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the TUM ingest run")
    print(f"tum: tracked frames/s {info['tracked_fps']:.4f}; Adam iterations a frame "
          f"{info['adam_iters_mean']:.2f}; launches {launches}; keyframes {info['keyframes']}; "
          f"keyframe ATE {info['keyframe_ate_cm']:.4f} cm; loader {info['loader_ms_per_frame']} "
          f"ms a frame (Paeth rows) against tracking {info['tracking_ms_per_frame']} ms "
          f"(the next frame's fetch apart); checkpoint "
          f"{info['checkpoint_bytes']} bytes, save {save_ms:.1f} ms, resume "
          f"{info['resume_ms']:.1f} ms; resumed frames {info['resumed_frames']} keyframe ATE "
          f"{info['resumed_keyframe_ate_cm']:.4f} cm", flush=True)
    return info, launches, snapshot, thread, dp


class ViewerThread:
    """A headless viewer on a host thread and CUDA stream of its own: it
    renders the newest `GaussianPacket` of `channel` through
    `OfflineViewer.tick` (`render_view`, K1) into `out_dir`."""

    def __init__(self, channel, intr, out_dir):
        from monogs_dev_tpu_torch.viz import OfflineViewer, VizChannel

        self.source, self.local = channel, VizChannel()
        self.viewer = OfflineViewer(self.local, intr, out_dir)
        self.stop_event = threading.Event()
        self.renders, self.error = 0, None
        self.thread = threading.Thread(target=self._run, name="viewer")

    def _run(self):
        import torch

        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                while not self.stop_event.is_set():
                    packet = self.source.latest()
                    if packet is None:
                        time.sleep(0.01)
                        continue
                    self.local.publish(packet)
                    if self.viewer.tick(packet.params, packet.active) is not None:
                        self.renders += 1
                torch.cuda.current_stream().synchronize()
        except BaseException as e:  # reported by stop()
            self.error = e

    def stop(self):
        self.stop_event.set()
        self.thread.join(timeout=60)


class HandoffChecks:
    """Snapshot integrity across the backend thread's hand-off, wrapped
    around it (the main path is unchanged): at each `push_to_frontend` a
    float64 checksum of the map's xyz, opacity and f_dc on the backend's
    stream; when the frontend replaces that snapshot, the same checksum on
    the frontend's stream. Also counts the frames the frontend tracked while
    a keyframe was out on the backend."""

    def __init__(self, slam):
        self.pending, self.pairs, self.tracked_in_flight = {}, [], 0
        bt, fe = slam.backend_thread, slam.frontend
        push, adopt, tracking = bt.push_to_frontend, fe._adopt_snapshot, fe.tracking

        def checked_push(tag="sync_backend"):
            params = slam.engine.gmap.params
            self.pending[id(params.xyz)] = (params.xyz, self.checksum(params))
            push(tag)

        def checked_adopt(snapshot, *args, **kwargs):
            old = fe.snapshot[0]
            hit = self.pending.pop(id(old.xyz), None)
            if hit is not None and hit[0] is old.xyz:
                self.pairs.append((hit[1], self.checksum(old)))
            adopt(snapshot, *args, **kwargs)

        def counted_tracking(*args, **kwargs):
            self.tracked_in_flight += fe.requested_keyframe > 0
            return tracking(*args, **kwargs)

        bt.push_to_frontend, fe._adopt_snapshot, fe.tracking = (checked_push, checked_adopt,
                                                                counted_tracking)

    @staticmethod
    def checksum(params):
        import torch

        return torch.stack([params.xyz.double().sum(), params.opacity_logit.double().sum(),
                            params.f_dc.double().sum()])

    def mismatches(self):
        return [i for i, (a, b) in enumerate(self.pairs) if not bool((a.cpu() == b.cpu()).all())]


def dp_phase(config, dev, path, next_frame, inline_fps, before_keyframe):
    """(a) The checkpoint resumed with `TPU.mesh_devices: DP_MESH_DEVICES`
    (the config otherwise as committed; on one card a mesh of one device):
    every mapping round through `_map_dp`, RESUME_FRAMES frames timed; then
    `before_keyframe`, the TUM run's own state one frame before its
    keyframe, resumed into the same `SLAM` and tracked on until that
    keyframe's mapping round has run through `_map_dp`, then one frame more
    (within DP_BUDGET_S; until the Replica phase took their time, the run
    went on from the resumed frames to the next keyframe, 73); K1, K2 and K3
    counted from the first resume on. (b) One
    `dp_mapping_step` at full width, the window's keyframes over its 10 VGA
    slots, over the meshes [cuda:0, cuda:0] and [cuda:0] from the same state,
    held to each other at tests/test_parallel.py's bounds (the replicas of
    the one-card mesh are the lead's own tensors); [cuda:0, cuda:1] too
    where there are two cards, its replicas equal bit for bit; the
    step's ms at 1 and 2 shards in turns, and the ms an iteration of the
    single path's `mapping_iterations` over the same window. Returns (info,
    launches)."""
    import copy

    import torch

    from monogs_dev_tpu_torch.core.mapping import (KeyframeBatch, make_keyframe_opt_state,
                                                   mapping_iterations)
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.parallel import (DPBatch, dp_mapping_step, gather,
                                                 make_dp_opt_state, make_mesh, replicate,
                                                 shard_batch)

    t_phase = time.time()
    dcfg = copy.deepcopy(config)
    dcfg["TPU"]["mesh_devices"] = DP_MESH_DEVICES
    slam = SLAM(dcfg, dev, seed=0)
    e, fe = slam.engine, slam.frontend
    if e.mesh is None or e._dp_step is None:
        fail("dp: TPU.mesh_devices built no mesh")
    # (frame, iterations, init mode, keyframe or None) of every _map_dp round
    rounds = []
    in_keyframe = [None]
    map_dp, map_single, handle_keyframe = e._map_dp, e._map_single, e.handle_keyframe

    def record(iters, frames_to_optimize, init_mode=False):
        rounds.append((fe.cur_frame_idx, int(iters), bool(init_mode), in_keyframe[0]))
        return map_dp(iters, frames_to_optimize, init_mode)

    def single(*args, **kwargs):
        fail("dp: a mapping round took the single-device path")

    def keyframe(frame_idx, *args, **kwargs):
        in_keyframe[0] = frame_idx
        try:
            return handle_keyframe(frame_idx, *args, **kwargs)
        finally:
            in_keyframe[0] = None

    e._map_dp, e._map_single, e.handle_keyframe = record, single, keyframe
    torch.cuda.synchronize()
    B.reset_launch_counts()
    slam.resume(path)  # its re-harvest is a one-iteration round
    iters0, kf0, n0 = e.telemetry["map_iters"], len(fe.kf_indices), len(rounds)
    end = next_frame + RESUME_FRAMES
    t0 = time.time()
    slam.run(max_frames=end)
    torch.cuda.synchronize()
    info = {"mesh_devices": DP_MESH_DEVICES, "mesh": [str(d) for d in e.mesh.devices],
            "slots": e._dp_slots, "fps": RESUME_FRAMES / (time.time() - t0),
            "inline_resumed_fps": inline_fps}
    n = slam.resume(before_keyframe)
    start, kf0, t0 = n, len(fe.kf_indices), time.time()
    while len(fe.kf_indices) <= kf0 and n < INGEST_FRAMES - 1 and time.time() - t0 < DP_BUDGET_S:
        n += 1
        slam.run(max_frames=n)  # ends with the keyframe's mapping pumped
    slam.run(max_frames=n + 1)  # one frame more
    torch.cuda.synchronize()
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    gmap = e.gmap
    act = gmap.aux.active
    info.update(
        frames_run=[[next_frame, end], [start, n + 1]], keyframes=list(fe.kf_indices),
        rounds=len(rounds),
        keyframe_rounds=[r for r in rounds if r[3] is not None],
        map_iters=e.telemetry["map_iters"] - iters0, dp_steps=sum(r[1] for r in rounds[n0:]),
        slot_adam_count=e._dp_state.count, alive=int(act.sum()),
        keyframe_ate_cm=100.0 * slam.keyframe_ate(), launches=launches,
        map_finite=all(bool(torch.isfinite(x[act]).all()) for x in gmap.params.values()),
        telemetry={k: e.telemetry[k] for k in ("dp_init_iters", "dp_densify_events", "dp_resets",
                                               "map_iters", "densify_dropped")})
    print(f"dp: mesh_devices {DP_MESH_DEVICES} built a mesh of {e.mesh.size} device(s) "
          f"{info['mesh']} ({torch.cuda.device_count()} visible), {e._dp_slots} slots", flush=True)
    if len(fe.kf_indices) <= kf0 or not info["keyframe_rounds"] \
            or fe.kf_indices[-1] not in e.viewpoints:
        fail(f"dp: no keyframe inserted and mapped through _map_dp by frame {n} "
             f"({DP_BUDGET_S} s budget): {rounds}")
    if info["map_iters"] != info["dp_steps"]:
        fail(f"dp: the telemetry counts {info['map_iters']} mapping iterations, the rounds "
             f"ran {info['dp_steps']}")
    if not info["map_finite"] or not all(np.isfinite(fe.cameras[i].T_est).all()
                                         for i in fe.cameras):
        fail("dp: the map or a pose is not finite")
    if not info["keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"dp: keyframe ATE {info['keyframe_ate_cm']} cm")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the data-parallel run")

    # (b) one step at full width, over two meshes from the same state: the
    # window's keyframes (two at this point of the sequence) in turn over
    # every slot, so that each shard of [cuda:0, cuda:0] renders five
    b = e._dp_slots
    ids = [e.current_window[k % len(e.current_window)] for k in range(b)]
    images, depths = e._stack_slots(ids, b)
    on = torch.ones(b, dtype=torch.bool, device=dev)
    kb = KeyframeBatch(
        images=images, depths=depths,
        T_w2c=torch.as_tensor(np.stack([e.viewpoints[i].T_w2c for i in ids]), dtype=torch.float32,
                              device=dev),
        exposure=torch.as_tensor(np.stack([e.viewpoints[i].exposure for i in ids]),
                                 dtype=torch.float32, device=dev),
        valid=on, optimize_pose=torch.tensor([i != 0 for i in ids], device=dev),
        optimize_exposure=torch.tensor([i != 0 for i in ids], device=dev), apply_exposure=on,
        harvest_visibility=on)
    batch = DPBatch(images=kb.images, depths=kb.depths, T_w2c=kb.T_w2c, exposure=kb.exposure,
                    valid=kb.valid, optimize_pose=kb.optimize_pose,
                    optimize_exposure=kb.optimize_exposure)
    it = e.iteration_count
    noise = torch.zeros((2, 1, 3), device=dev)

    class NoDraws:  # densify is off in these steps
        @staticmethod
        def split_noise(budget):
            return noise

    def run(devices):
        mesh = make_mesh(device=devices)
        step = dp_mapping_step(mesh, e.cfg, e.opt_cfg, e.intr, e.raster_cfg,
                               use_depth=e.use_depth, update_every=1 << 30, update_offset=0,
                               size_threshold=e.size_threshold)
        sharded = shard_batch(mesh, batch)

        def once():
            return step(gmap, sharded, make_dp_opt_state(e._dp_slots, dev), it, NoDraws(),
                        e.gaussian_th, e.gaussian_extent)
        return mesh, once

    def held(a, b, label):
        """tests/test_parallel.py's bounds between two steps' results."""
        (ga, ba, oa, la, _), (gb, bb, ob, lb, _) = a, b
        errs = {"loss": abs(float(la) - float(lb)) / abs(float(lb))}
        mu_ok = True
        for (name, x), (_, y) in zip(_map_fields(ga), _map_fields(gb)):
            if name.startswith("adam_mu.") and x.numel():
                errs[name] = float((x - y).abs().max())
                mu_ok &= bool(((x - y).abs() <= DP_MU_ATOL + DP_MU_RTOL * y.abs()).all())
        errs["T_w2c"] = float((gather(ba.T_w2c, dev) - gather(bb.T_w2c, dev)).abs().max())
        errs["exposure"] = float((gather(ba.exposure, dev) - gather(bb.exposure, dev))
                                 .abs().max())
        errs["slot_mu"] = float((gather(oa.mu, dev) - gather(ob.mu, dev)).abs().max())
        finite = all(bool(torch.isfinite(x).all()) for _, x in _map_fields(ga)
                     if x.is_floating_point()) and np.isfinite(float(la))
        ok = (finite and errs["loss"] <= DP_LOSS_RTOL and errs["T_w2c"] <= DP_POSE_ATOL
              and errs["exposure"] <= DP_POSE_ATOL and errs["slot_mu"] <= DP_SLOT_MU_ATOL
              and mu_ok)
        print(f"dp step {label}: " + json.dumps(errs), flush=True)
        if not ok:
            fail(f"dp step {label}: outside the bounds (or not finite): {errs}")
        return errs

    def replicas_equal(mesh, out):
        """Every replica of a mesh whose shards lie on distinct cards equals
        the lead's map bit for bit."""
        g = out[0]
        return all(torch.equal(a.to(dev), g.aux.active) and
                   all(torch.equal(x.to(dev), y) for x, y in zip(p.values(), g.params.values()))
                   for p, a in replicate(mesh, g.params, g.aux.active)[1:])

    def replicas_shared(mesh, out):
        """On one card `replicate` copies nothing: every replica is the
        lead's own tensors (so their equality says nothing there)."""
        g = out[0]
        return all(a is g.aux.active and all(x is y for x, y in zip(p.values(),
                                                                    g.params.values()))
                   for p, a in replicate(mesh, g.params, g.aux.active))

    cuda0 = torch.device(dev)  # cuda:0
    mesh1, one = run([cuda0])
    mesh2, two = run([cuda0, cuda0])
    out1, out2 = one(), two()
    info["step_2_vs_1"] = held(out2, out1, "[cuda:0, cuda:0] vs [cuda:0]")
    if not replicas_shared(mesh2, out2):
        fail("dp step: [cuda:0, cuda:0] copied the map on its one card")
    del out1, out2
    times = {1: [], 2: []}
    for n_shards, fn in ((1, one), (2, two), (2, two), (1, one)) * DP_STEP_REPS:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times[n_shards].append(1e3 * (time.time() - t0))
    info["step_ms"] = {k: statistics.median(v) for k, v in times.items()}
    if torch.cuda.device_count() >= 2:
        mesh_b, two_cards = run([cuda0, torch.device("cuda", 1)])
        out_b = two_cards()
        info["step_two_cards_vs_1"] = held(out_b, one(), "[cuda:0, cuda:1] vs [cuda:0]")
        if not replicas_equal(mesh_b, out_b):
            fail("dp step: the replicas of [cuda:0, cuda:1] are not equal bit for bit")
        info["replicas_equal"] = True
    else:
        info["step_two_cards_vs_1"] = "not run: one visible card"
        info["replicas_equal"] = "not run: one visible card"
        print("dp step [cuda:0, cuda:1] and its replicas' equality: not run (one visible "
              "card; on [cuda:0, cuda:0] the replicas are the lead's own tensors)", flush=True)

    class Draws:
        @staticmethod
        def begin_iteration():
            pass

    torch.cuda.synchronize()
    t0 = time.time()
    mapping_iterations(gmap, kb, make_keyframe_opt_state(e._dp_slots, dev), it, Draws(),
                       e.bg_color, e.gaussian_th, e.gaussian_extent, e.cfg, e.opt_cfg, e.intr,
                       e.raster_cfg, iters=DP_SINGLE_ITERS, update_every=1 << 30,
                       update_offset=0, reset_interval=1 << 30,
                       size_threshold=e.size_threshold, use_depth=e.use_depth,
                       init_mode=False)
    torch.cuda.synchronize()
    info["single_ms_per_iteration"] = 1e3 * (time.time() - t0) / DP_SINGLE_ITERS
    info["phase_s"] = time.time() - t_phase
    slam.stop()
    print("dp: " + json.dumps(info), flush=True)
    print(f"dp: frames/s {info['fps']:.4f} against the inline resumed run's {inline_fps:.4f} "
          f"(frames [{next_frame}, {end})); keyframes {info['keyframes']}, keyframe rounds "
          f"{info['keyframe_rounds']}, mapping iterations {info['map_iters']} in "
          f"{info['rounds']} rounds; keyframe ATE {info['keyframe_ate_cm']:.4f} cm; launches "
          f"{launches}; one step at {e._dp_slots} VGA slots {info['step_ms'][1]:.1f} ms on 1 "
          f"shard, {info['step_ms'][2]:.1f} ms on 2 (same card), single path "
          f"{info['single_ms_per_iteration']:.1f} ms an iteration; phase "
          f"{info['phase_s']:.1f} s | {smi_line()}", flush=True)
    return info, launches


def thread_phase(config, dev, path, next_frame, tmp, inline_fps, before_keyframe):
    """The checkpoint resumed with the backend on its own thread and stream
    (`TPU.scheduler: thread`) and the viewer channel open (`Results.use_gui`),
    a headless viewer rendering each new packet on a thread of its own: the
    RESUME_FRAMES frames, in turns with a second inline resumed run over
    them (the first ran in `tum_ingest`); then `before_keyframe`, the TUM
    run's own state one frame before its keyframe, resumed into the same
    thread-mode `SLAM` and run on, frame by frame, until the backend thread
    has mapped that keyframe while the frontend tracked on (within
    THREAD_BUDGET_S). (Until the dp phase took their time, this run tracked
    on in thread mode from the resumed frames to the next keyframe, 76.) No
    frame of it is profiled: `torch.profiler` around a frame whose backward
    ran while the backend thread ran its own killed the process
    (`profile_frames`). Returns (info, launches by path)."""
    import copy

    import torch

    from monogs_dev_tpu_torch.core.backend import BackendThread
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.ops import blend as B

    t_phase = time.time()
    tcfg = copy.deepcopy(config)
    tcfg["TPU"]["scheduler"] = "thread"
    tcfg["Results"]["use_gui"] = True
    slam = SLAM(tcfg, dev, seed=0)
    bt, fe = slam.backend_thread, slam.frontend
    if not isinstance(bt, BackendThread):
        fail("thread: TPU.scheduler thread did not select BackendThread")
    slam.resume(path)
    checks = HandoffChecks(slam)
    viewer = ViewerThread(slam.viz_channel, slam.intr, os.path.join(tmp, "viewer"))
    viewer.thread.start()
    launches = {"thread": dict.fromkeys(("K1", "K2", "K3"), 0), "viewer": {"K1": 0},
                "tum_vga_inline2": {}}

    def tally(path_name):
        torch.cuda.synchronize()
        for k in launches[path_name]:
            launches[path_name][k] += B.LAUNCHES[k]
        launches["viewer"]["K1"] += B.THREAD_LAUNCHES.get("viewer", {}).get("K1", 0)

    info = {}
    end = next_frame + RESUME_FRAMES
    try:
        torch.cuda.synchronize()
        B.reset_launch_counts()
        iters0 = slam.engine.telemetry["map_iters"]
        t0 = time.time()
        slam.run(max_frames=end)  # starts the backend thread
        torch.cuda.synchronize()
        info["thread_fps"] = RESUME_FRAMES / (time.time() - t0)
        tally("thread")

        # the second inline run, with the thread held idle
        bt.backend_queue.put(["pause"])
        with bt.held():
            pass
        inline = SLAM(config, dev, seed=0)
        inline.resume(path)
        torch.cuda.synchronize()
        B.reset_launch_counts()
        t0 = time.time()
        inline.run(max_frames=end)
        torch.cuda.synchronize()
        info["inline_fps"] = [inline_fps, RESUME_FRAMES / (time.time() - t0)]
        launches["tum_vga_inline2"] = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
        info["inline2_keyframe_ate_cm"] = 100.0 * inline.keyframe_ate()
        inline.stop()
        del inline
        bt.backend_queue.put(["unpause"])

        # from the TUM run's frame before its keyframe, on until that keyframe
        # was mapped on the thread while the frontend tracked
        B.reset_launch_counts()
        n, t0 = slam.resume(before_keyframe), time.time()
        info["before_keyframe_frame"] = n
        last = INGEST_FRAMES - 1
        while (bt.handled["keyframe"] < 1 or checks.tracked_in_flight < 1) and n < last \
                and time.time() - t0 < THREAD_BUDGET_S:
            n += 1
            slam.run(max_frames=n)
        info["frames_run"] = [[next_frame, end], [info["before_keyframe_frame"], n]]
        tally("thread")
        info["map_iters"] = slam.engine.telemetry["map_iters"] - iters0
    finally:
        slam.stop()
        viewer.stop()
    torch.cuda.synchronize()
    info.update(
        idle_rounds=bt.handled["idle"], keyframes_handled=bt.handled["keyframe"],
        tracked_in_flight=checks.tracked_in_flight, keyframes=list(fe.kf_indices),
        keyframe_ate_cm=100.0 * slam.keyframe_ate(), viewer_renders=viewer.renders,
        viewer_k1=launches["viewer"]["K1"], integrity_checks=len(checks.pairs),
        integrity_mismatches=checks.mismatches(), launches=launches["thread"],
        phase_s=time.time() - t_phase, timers=slam.timers.summary())
    print("thread: " + json.dumps(info), flush=True)
    if viewer.error is not None:
        fail(f"thread: the viewer thread failed: {viewer.error!r}")
    if bt.is_alive() or viewer.thread.is_alive():
        fail("thread: a thread is alive after stop()")
    if info["integrity_mismatches"] or not info["integrity_checks"]:
        fail(f"thread: snapshot checksums differ at {info['integrity_mismatches']} of "
             f"{info['integrity_checks']} hand-offs")
    if info["keyframes_handled"] < 1 or info["tracked_in_flight"] < 1:
        fail(f"thread: no keyframe mapped on the thread while the frontend tracked by frame "
             f"{n} ({THREAD_BUDGET_S} s budget)")
    if not all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras) or \
            not info["keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"thread: poses not finite or keyframe ATE {info['keyframe_ate_cm']} cm")
    if info["idle_rounds"] <= 0 or info["viewer_renders"] <= 0 or info["viewer_k1"] <= 0:
        fail("thread: no idle round, no viewer render or no K1 from the viewer thread")
    for name, k in info["launches"].items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the thread-mode run")
    print(f"thread: frames/s {info['thread_fps']:.4f} against inline "
          f"{info['inline_fps'][0]:.4f} (before) and {info['inline_fps'][1]:.4f} (after), "
          f"frames [{next_frame}, {end}); then frames [{info['before_keyframe_frame']}, {n}) "
          f"from the TUM run's state; idle rounds {info['idle_rounds']}, mapping "
          f"iterations {info['map_iters']}; frames tracked while a keyframe mapped "
          f"{info['tracked_in_flight']}; keyframes handled {info['keyframes_handled']}, "
          f"keyframes {info['keyframes']}, keyframe ATE {info['keyframe_ate_cm']:.4f} cm; viewer "
          f"renders {info['viewer_renders']}, K1 from the viewer thread {info['viewer_k1']}; "
          f"integrity checks {info['integrity_checks']} equal; phase {info['phase_s']:.1f} s",
          flush=True)
    return info, launches


def euroc_ingest(dev, tmp):
    """(d): the EuRoC-layout stereo sequence and the EuRoC base config on it
    (rectification and matcher on the card). Returns (info, launches)."""
    import torch

    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.data.stereo import sgbm_disparity
    from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.ops.raster_types import RasterConfig
    from monogs_dev_tpu_torch.ops.rasterize import render_median_depth
    from monogs_dev_tpu_torch.tools import make_fixtures as mf
    from monogs_dev_tpu_torch.utils.config import load_config

    w, h = EUROC_SIZE
    params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n6000.npz"), dev)
    t0 = time.time()
    ds_cfg = mf.write_euroc(os.path.join(tmp, "euroc"), params, active, EUROC_FRAMES, w, h)
    write_s = time.time() - t0
    config = load_config(EUROC_CONFIG)
    config["Dataset"].update(dataset_path=ds_cfg["dataset_path"],
                             Calibration=ds_cfg["Calibration"])
    config["TPU"].update(EUROC_TPU)
    slam = SLAM(config, dev, seed=0)
    ds = slam.dataset

    # the matcher alone on frame 1's rectified pair, and its depth against
    # the scene's median depth (the JAX test's bars)
    left, right = ds.rectified_pair(1)
    matcher_ms = cuda_ms(lambda: sgbm_disparity(left, right), reps=5)
    image, depth, pose = ds[1]
    fx = 0.9 * w
    gt = render_median_depth(params, active, torch.as_tensor(pose, dtype=torch.float32,
                                                             device=dev),
                             Intrinsics(fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, width=w,
                                        height=h),
                             RasterConfig(max_per_tile=512, k_dup=16))
    valid = (depth > 0.1) & (depth < 10.0) & (gt > 0.1)
    rel = ((depth - gt).abs() / gt)[valid]
    loader_ms = cuda_ms(lambda: ds[2], reps=3)
    torch.cuda.synchronize()
    B.reset_launch_counts()
    t1 = time.time()
    slam.run()
    torch.cuda.synchronize()
    run_s = time.time() - t1
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    fe = slam.frontend
    info = {
        "frames": len(fe.cameras),
        "size": [w, h],
        "write_s": write_s,
        "matcher_ms_per_frame": matcher_ms,
        "loader_ms_per_frame": loader_ms,
        "valid_share": float(valid.float().mean()),
        "median_rel_depth_err": float(rel.median()) if rel.numel() else float("nan"),
        "fps": len(fe.cameras) / run_s,
        "keyframes": list(fe.kf_indices),
        "alive": slam.n_alive(),
        "keyframe_ate_cm": 100.0 * slam.keyframe_ate(),
        "launches": launches,
        "timers": slam.timers.summary(),
    }
    assert_loader_never_waits("euroc", fe, range(2))
    slam.stop()
    print("euroc: " + json.dumps(info), flush=True)
    if not info["valid_share"] > STEREO_VALID_BAR:
        fail(f"euroc: valid-disparity share {info['valid_share']} <= {STEREO_VALID_BAR}")
    if not info["median_rel_depth_err"] < STEREO_REL_BAR:
        fail(f"euroc: median relative depth error {info['median_rel_depth_err']}")
    if info["frames"] != EUROC_FRAMES or not all(np.isfinite(fe.cameras[i].T_est).all()
                                                 for i in fe.cameras):
        fail("euroc: frames missing or not finite")
    if not info["keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"euroc: keyframe ATE {info['keyframe_ate_cm']} cm")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the EuRoC run")
    print(f"euroc: matcher {matcher_ms:.2f} ms a frame ({w}x{h}); valid share "
          f"{info['valid_share']:.4f}; median relative depth error "
          f"{info['median_rel_depth_err']:.4f}; keyframes {info['keyframes']}; keyframe ATE "
          f"{info['keyframe_ate_cm']:.4f} cm; {info['fps']:.4f} frames/s; launches {launches}",
          flush=True)
    return info, launches


def replica_phase(dev):
    """`configs/rgbd/replica/office0_sp.yaml` as committed (1200x680, its
    Training budgets, `Dataset.single_thread`) on a Replica-layout sequence
    written on the card by `write_replica` (JPEG colour, 16-bit PNG depth),
    through `SLAM` and the port's JPEG decoder (no PIL in the process): to
    its first keyframe after frame 0 within REPLICA_BUDGET_S. Checks finite
    poses, keyframe ATE, K1-K3 launched, the frame fetch under sync debug
    mode, every written frame decoded on the card equal to its decode on the
    CPU, frame 0's coefficients from the C entropy decoder equal to the plain
    one's on a crop, and each frame's round-trip PSNR. Returns (info,
    launches)."""
    import tempfile

    import torch

    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.data import image_io, jpeg
    from monogs_dev_tpu_torch.data.datasets import ReplicaDataset
    from monogs_dev_tpu_torch.data.synthetic import SCENE_DIR
    from monogs_dev_tpu_torch.models.camera import Intrinsics
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.tools import make_fixtures as mf
    from monogs_dev_tpu_torch.utils.config import load_config

    t_phase = time.time()
    if "PIL" in sys.modules:
        fail("replica: PIL is imported in this process")
    config = load_config(REPLICA_CONFIG)
    cal = config["Dataset"]["Calibration"]
    intr = Intrinsics(fx=float(cal["fx"]), fy=float(cal["fy"]), cx=float(cal["cx"]),
                      cy=float(cal["cy"]), width=int(cal["width"]), height=int(cal["height"]))
    with tempfile.TemporaryDirectory(prefix="replica_") as tmp:
        seq = os.path.join(tmp, "office0_sp")
        params, active = mf.load_params(os.path.join(SCENE_DIR, "surface_seed0_n8000.npz"), dev)
        poses = mf.orbit(REPLICA_FRAMES, n=REPLICA_ORBIT_N, sweep=0.45)
        t0 = time.time()
        mf.write_replica(seq, params, active, intr, poses,
                         depth_scale=float(cal["depth_scale"]))
        torch.cuda.synchronize()
        write_s = time.time() - t0
        config["Dataset"]["dataset_path"] = seq
        config["Results"]["save_results"] = False

        slam = SLAM(config, dev, seed=0)
        fe, ds = slam.frontend, slam.dataset
        if not isinstance(ds, ReplicaDataset) or (ds.width, ds.height) != (1200, 680):
            fail("replica: the config did not load a 1200x680 ReplicaDataset")
        recorder = TrackRecorder(fe, -1)
        frontend_mod.track_frame = recorder
        try:
            torch.cuda.synchronize()
            B.reset_launch_counts()
            t0 = time.time()
            slam.run(max_frames=2)  # frame 0, its init mapping, frame 1
            torch.cuda.synchronize()
            t1 = time.time()
            n = 2
            while len(fe.kf_indices) < 2 and n < len(ds) and time.time() - t0 < REPLICA_BUDGET_S:
                n += 1
                slam.run(max_frames=n)  # ends with the keyframe's mapping pumped
            torch.cuda.synchronize()
            t2 = time.time()
        finally:
            frontend_mod.track_frame = recorder.track_frame
        launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
        frames = sorted(fe.cameras)
        iters = [recorder.iters[i] for i in sorted(recorder.iters)]
        info = {
            "config": os.path.relpath(REPLICA_CONFIG, REPO),
            "size": [ds.width, ds.height],
            "frames_written": REPLICA_FRAMES,
            "frames_run": n,
            "write_s": write_s,
            "jpeg_bytes_per_frame": os.path.getsize(ds.color_paths[0]),
            "init_and_first_frame_s": t1 - t0,
            "fps_after_init": (n - 2) / (t2 - t1) if n > 2 else None,
            "adam_iters_mean": float(np.mean(iters)) if iters else None,
            "keyframes": list(fe.kf_indices),
            "alive": slam.n_alive(),
            "keyframe_ate_cm": 100.0 * slam.keyframe_ate(),
            "launches": launches,
            "loader_ms_per_frame": _frame_ms(slam.timers, "fetch_frame"),
            "tracking_ms_per_frame": _frame_ms(slam.timers, "tracking"),
            "timers": slam.timers.summary(),
        }
        if len(fe.kf_indices) < 2:
            fail(f"replica: no keyframe after frame 0 by frame {n} ({REPLICA_BUDGET_S} s)")
        if not all(np.isfinite(fe.cameras[i].T_est).all() for i in frames):
            fail("replica: non-finite pose")
        assert_loader_never_waits("replica", fe, range(3))
        slam.stop()
        del slam, fe

        # the decoder: the host's entropy stage and the card's device stage
        # timed on frame 1; every frame decoded on the card against the same
        # coefficients through the device stage on the CPU; frame 0's C
        # entropy decoder against its plain version on a crop
        with open(ds.color_paths[1], "rb") as f:
            data = f.read()
        reader = ds.reader
        host_s = []
        for _ in range(7):
            t0 = time.perf_counter()
            reader._host(jpeg.decode_coefficients, data, torch.int16)
            host_s.append(time.perf_counter() - t0)
        host_ms = 1e3 * statistics.median(host_s)
        info_1, buf = reader._host(jpeg.decode_coefficients, data, torch.int16)
        device_ms = cuda_ms(lambda: jpeg.reconstruct(info_1, buf), reps=7)
        psnr, unequal = [], []
        for i, path in enumerate(ds.color_paths):
            card = reader.samples(path).cpu()
            with open(path, "rb") as f:
                cpu = jpeg.decode(f.read(), "cpu")
            if not torch.equal(card, cpu):
                unequal.append(i)
            src, _ = mf.render_rgbd(params, active, poses[i], intr, depth=False)
            ref = np.clip(src * 255.0, 0, 255).astype(np.uint8).astype(np.float64)
            mse = float(((card.numpy().astype(np.float64) - ref) ** 2).mean())
            psnr.append(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
        h, w = PLAIN_CROP
        crop = jpeg.encode_jpeg(reader.samples(ds.color_paths[0]).cpu().numpy()[:h, :w],
                                image_io.JPEG_QUALITY)
        coef_c = jpeg.decode_coefficients(crop)[1]
        coef_plain = jpeg.decode_coefficients(crop, entropy=jpeg.decode_scan_plain)[1]
        del params, active
    info.update(decode_host_ms=host_ms, decode_device_ms=device_ms, psnr_db=psnr,
                psnr_min_db=min(psnr), frames_unequal=unequal,
                plain_entropy_equal_on_crop=bool(np.array_equal(coef_c, coef_plain)),
                phase_s=time.time() - t_phase)
    print("replica: " + json.dumps(info), flush=True)
    if not info["keyframe_ate_cm"] < 100.0 * RGBD_ATE_BAR:
        fail(f"replica: keyframe ATE {info['keyframe_ate_cm']} cm over {info['keyframes']}")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the Replica run")
    if unequal:
        fail(f"replica: frames {unequal} decode differently on the card and on the CPU")
    if not info["plain_entropy_equal_on_crop"]:
        fail("replica: the C entropy decoder differs from its plain version on frame 0's crop")
    if not info["psnr_min_db"] > REPLICA_PSNR_BAR:
        fail(f"replica: a decoded frame's PSNR {info['psnr_min_db']} dB is not above "
             f"{REPLICA_PSNR_BAR} dB against its render")
    print(f"replica: {info['config']} at {ds.width}x{ds.height}; frames/s after init "
          f"{info['fps_after_init']} over frames [2, {n}); init and frame 1 "
          f"{info['init_and_first_frame_s']:.1f} s; keyframes {info['keyframes']}, keyframe ATE "
          f"{info['keyframe_ate_cm']:.4f} cm; launches {launches}; loader "
          f"{info['loader_ms_per_frame']} ms a frame (JPEG + 16-bit PNG), JPEG decode: host "
          f"entropy {host_ms:.3f} ms + device stage {device_ms:.3f} ms; write "
          f"{write_s:.1f} s for {REPLICA_FRAMES} frames; PSNR min {info['psnr_min_db']:.2f} dB; "
          f"phase {info['phase_s']:.1f} s", flush=True)
    return info, launches


def replay_phase(dev):
    """`configs/live/realsense_replay.yaml` with the fixture-eval tool's
    overrides on the first REPLAY_FRAMES frames of its replay sequence,
    written on the card, through `load_dataset` and `SLAM`, frame by frame:
    the monocular initialization at frame 0 (the bootstrap depth sheet and
    the initial BA at the config's 10x position_lr_init), then on until the
    first keyframe after it has been mapped, within REPLAY_BUDGET_S. Checks
    finite poses, no reset (a re-initialization) after it, the Sim(3)-aligned
    ATE of every frame against `gt_poses.npy` (the loader's poses are
    identity; the keyframes' own, from a third keyframe on: two keyframes
    do not determine a similarity), K1-K3 launched and the fetch under sync
    debug mode.
    Returns (info, launches, a copy of the map at initialization for
    `map_kernel_phase`, its intrinsics, raster config and rebin dilation)."""
    import tempfile

    import torch

    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.data.datasets import RealsenseReplayDataset
    from monogs_dev_tpu_torch.eval.ate import ate_rmse
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.tools import make_fixtures as mf
    from monogs_dev_tpu_torch.tools import run_fixture_evals as rfe
    from monogs_dev_tpu_torch.utils.config import load_config

    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="replay_") as tmp:
        seq = os.path.join(tmp, "replay")
        params, active = mf.load_params(mf.REPLAY_SCENE, dev)
        t0 = time.time()
        ds_cfg = mf.write_replay(seq, params, active, n_frames=REPLAY_FRAMES,
                                 orbit_n=REPLAY_ORBIT_N)
        torch.cuda.synchronize()
        write_s = time.time() - t0
        del params, active
        gt = np.load(os.path.join(seq, "gt_poses.npy"))
        config = load_config(rfe.REPLAY_CONFIG)
        config["Dataset"]["dataset_path"] = seq
        config["Dataset"]["Calibration"].update(ds_cfg["Calibration"])
        config["TPU"].update(rfe.REPLAY_TPU)
        slam = SLAM(config, dev, seed=0)
        fe, ds = slam.frontend, slam.dataset
        if not isinstance(ds, RealsenseReplayDataset) or (ds.width, ds.height) != (640, 480):
            fail("replay: the config did not load a 640x480 RealsenseReplayDataset")
        inits = []  # frames at which the frontend (re)initialized the map
        initialize = fe.initialize

        def counting_initialize(idx, *args):
            inits.append(idx)
            return initialize(idx, *args)

        fe.initialize = counting_initialize
        snapshot = None
        torch.cuda.synchronize()
        B.reset_launch_counts()
        t0 = time.time()
        slam.run(max_frames=1)  # frame 0, then its initialization (the BA) pumped
        torch.cuda.synchronize()
        init_s = time.time() - t0
        snapshot = snapshot_map(slam, fe.kf_indices[0], "replay init map")
        n = 1
        while len(fe.kf_indices) < 2 and n < len(ds) and time.time() - t0 < REPLAY_BUDGET_S:
            n += 1
            slam.run(max_frames=n)  # ends with a keyframe's mapping pumped
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
        kfs = list(fe.kf_indices)
        frames = sorted(fe.cameras)
        # a similarity fitted to two keyframes is not determined: their ATE
        # only from a third on
        ate = (ate_rmse([fe.cameras[i].T_est for i in kfs], [gt[i] for i in kfs],
                        correct_scale=True) if len(kfs) >= 3 else None)
        ate_all = ate_rmse([fe.cameras[i].T_est for i in frames], [gt[i] for i in frames],
                           correct_scale=True)
        fetch_ms = _frame_ms(slam.timers, "fetch_frame")
        tracking_ms = _frame_ms(slam.timers, "tracking")
        info = {
            "config": os.path.relpath(rfe.REPLAY_CONFIG, REPO),
            "tpu_overrides": rfe.REPLAY_TPU,
            "size": [ds.width, ds.height],
            "frames_written": REPLAY_FRAMES,
            "frames_run": n,
            "write_s": write_s,
            "init_s": init_s,
            "run_s": run_s,
            "fps": n / run_s,
            "fps_after_init": (n - 1) / (run_s - init_s) if n > 1 else None,
            "init_frames": inits,
            "keyframes": kfs,
            "alive": slam.n_alive(),
            "keyframe_ate_cm": 100.0 * ate if ate is not None else None,
            "all_frame_ate_cm": 100.0 * ate_all,
            "launches": launches,
            "loader_ms_per_frame": fetch_ms,
            "tracking_ms_per_frame": tracking_ms,
            "loader_share": fetch_ms / tracking_ms if fetch_ms and tracking_ms else None,
            "telemetry": slam.engine.telemetry,
            "timers": slam.timers.summary(),
        }
        print("replay: " + json.dumps(info), flush=True)
        if len(kfs) < 2:
            fail(f"replay: no keyframe after the initialization at frame {inits[-1]} by "
                 f"frame {n} ({REPLAY_BUDGET_S} s)")
        if len(inits) > 1:
            fail(f"replay: the monocular map was reset and initialized again at frames "
                 f"{inits[1:]}")
        if not all(np.isfinite(fe.cameras[i].T_est).all() for i in frames):
            fail("replay: non-finite pose")
        for label, value in (("keyframe", ate), ("all-frame", ate_all)):
            if value is not None and not (np.isfinite(value) and value < MONO_ATE_BAR):
                fail(f"replay: {label} ATE {value} m is not finite and under {MONO_ATE_BAR} m")
        for name, k in launches.items():
            if k <= 0:
                fail(f"kernel {name} was not launched in the replay run")
        assert_loader_never_waits("replay", fe, range(3))
        intr, rcfg = slam.intr, slam.raster_cfg
        dilate = slam.step_cfg.mapping_rebin_dilation
        slam.stop()
    info["phase_s"] = time.time() - t_phase
    print(f"replay: {info['config']} with the fixture-eval overrides at {ds.width}x{ds.height}; "
          f"initialized at frame {inits[-1]} in {init_s:.1f} s (initial BA); "
          f"{info['fps']:.4f} frames/s over {n} frames ({info['fps_after_init']:.4f} after "
          f"the initialization); keyframes {kfs}; ATE (Sim(3)) all frames "
          f"{info['all_frame_ate_cm']:.4f} cm, keyframes {info['keyframe_ate_cm']} cm; "
          f"loader {fetch_ms} ms a frame, {info['loader_share']:.4f} of tracking; launches "
          f"{launches}; write {write_s:.1f} s for {REPLAY_FRAMES} frames; phase "
          f"{info['phase_s']:.1f} s", flush=True)
    return info, launches, snapshot, intr, rcfg, dilate


def scale_phase(dev):
    """`configs/synthetic/scale_vga.yaml` as committed (640x480, capacity
    131,072, small tier 65,536, densify budgets 8,192 / 4,096) through
    `SLAM`, from frame 0 to its first keyframe after the initialization;
    then the growth path forced as
    tests/test_system.py::test_grow_back_under_insert_pressure forces it:
    the map compacted to the power of two above its alive rows plus 8, the
    visibility remapped with it, and on until a keyframe's insert has grown
    it back and that keyframe's mapping round has run, within
    SCALE_BUDGET_S. Checks map_grows >= 1, the rows back at the capacity,
    every field of the map finite after that round, finite poses and K1-K3
    launched under path `scale`. Returns (info, launches)."""
    import torch

    from monogs_dev_tpu_torch.core.backend import _next_pow2
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.models.gaussians import compact_map
    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.utils.config import load_config

    t_phase = time.time()
    config = load_config(SCALE_CONFIG)
    slam = SLAM(config, dev, seed=0)
    fe, e, ds = slam.frontend, slam.engine, slam.dataset
    if (ds.width, ds.height, e.capacity, e.tier_small) != (640, 480, 131072, 65536):
        fail("scale: the config did not load at 640x480 with capacity 131,072 and tier 65,536")
    grown_at = []
    add_next_kf = e.add_next_kf

    def recording_add(frame_idx, *args, **kw):
        before = e.telemetry["map_grows"]
        out = add_next_kf(frame_idx, *args, **kw)
        if e.telemetry["map_grows"] > before:
            grown_at.append(frame_idx)
        return out

    e.add_next_kf = recording_add
    torch.cuda.synchronize()
    B.reset_launch_counts()
    t0 = time.time()
    slam.run(max_frames=1)  # frame 0 and its initialization
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n = 1
    while len(fe.kf_indices) < 2 and n < len(ds) and time.time() - t0 < SCALE_BUDGET_S:
        n += 1
        slam.run(max_frames=n)  # ends with a keyframe's mapping pumped
    if len(fe.kf_indices) < 2:
        fail(f"scale: no keyframe after the initialization by frame {n} ({SCALE_BUDGET_S} s)")
    first_kf = fe.kf_indices[-1]
    alive = slam.n_alive()
    rows = e.map_rows()
    tight = _next_pow2(alive + 8)
    if tight >= rows:
        fail(f"scale: {alive} alive rows leave no tier under {rows}")
    e.gmap, perm = compact_map(e.gmap, tight)
    perm = perm.cpu().numpy()
    for k, v in list(e.occ_aware_visibility.items()):
        out = np.zeros(e.capacity, bool)
        out[:tight] = np.asarray(v)[perm[:tight]]
        e.occ_aware_visibility[k] = out
    t_grow = time.time()
    while not grown_at and n < len(ds) and time.time() - t0 < SCALE_BUDGET_S:
        n += 1
        slam.run(max_frames=n)  # the growing keyframe's insert, then its mapping round
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {k: B.LAUNCHES[k] for k in ("K1", "K2", "K3")}
    bad_fields = [name for name, x in _map_fields(e.gmap)
                  if x.is_floating_point() and not bool(torch.isfinite(x).all())]
    poses_finite = all(np.isfinite(fe.cameras[i].T_est).all() for i in fe.cameras)
    info = {
        "config": os.path.relpath(SCALE_CONFIG, REPO),
        "size": [ds.width, ds.height],
        "capacity": e.capacity,
        "tier_small": e.tier_small,
        "frames_run": n,
        "init_s": init_s,
        "to_growth_s": time.time() - t_grow,
        "run_s": run_s,
        "first_keyframe": first_kf,
        "alive_at_first_keyframe": alive,
        "tiers": [rows, tight, e.map_rows()],
        "grown_at_frame": grown_at,
        "alive": slam.n_alive(),
        "keyframes": list(fe.kf_indices),
        "launches": launches,
        "telemetry": e.telemetry,
    }
    slam.stop()
    info["phase_s"] = time.time() - t_phase
    print("scale: " + json.dumps(info), flush=True)
    if not grown_at or e.telemetry["map_grows"] < 1:
        fail(f"scale: no keyframe insert grew the {tight}-row tier by frame {n} "
             f"({SCALE_BUDGET_S} s)")
    if e.map_rows() != e.capacity:
        fail(f"scale: {e.map_rows()} rows after the growth, not the capacity {e.capacity}")
    if bad_fields:
        fail(f"scale: non-finite map fields after the growing keyframe's round: {bad_fields}")
    if not poses_finite:
        fail("scale: non-finite pose")
    for name, k in launches.items():
        if k <= 0:
            fail(f"kernel {name} was not launched in the scale run")
    print(f"scale: {info['config']} at {ds.width}x{ds.height}, capacity {e.capacity}; "
          f"initialized in {init_s:.1f} s; first keyframe {first_kf} with {alive} alive; tiers "
          f"{rows} -> {tight} (forced) -> {e.map_rows()} rows, grown at frame {grown_at}; "
          f"{info['alive']} alive at frame {n - 1}; launches {launches}; phase "
          f"{info['phase_s']:.1f} s", flush=True)
    return info, launches


def ingest_phase(dev):
    """Phase 9: `tum_ingest` and `euroc_ingest` in a temporary directory. Returns (tum info, euroc info, launches by
    path, the TUM map snapshot)."""
    import tempfile

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="ingest_") as tmp:
        tum, tum_launches, snapshot, (thread, thread_launches), (dp, dp_launches) = \
            tum_ingest(dev, tmp)
        euroc, euroc_launches = euroc_ingest(dev, tmp)
    print(f"ingest: phase {time.time() - t0:.1f} s", flush=True)
    return (tum, euroc, thread, dp, {"tum_vga": tum_launches, "euroc": euroc_launches,
                                     "dp": dp_launches, **thread_launches}, snapshot)



def main() -> int:
    t_start = time.time()
    # a fatal signal (a crash in native code) prints every thread's Python
    # stack to stderr before the process dies
    faulthandler.enable(all_threads=True)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from monogs_dev_tpu_torch.ops import blend as B
    from monogs_dev_tpu_torch.utils.config import load_config

    path, secs = B.build(verbose=True)
    print(f"build: {os.path.relpath(path, REPO)} in {secs:.2f} s", flush=True)
    from monogs_dev_tpu_torch.data import image_io, jpeg

    # the host C compiler: PNG rows and JPEG scans for the loaders
    for path, secs in (image_io.build(), jpeg.build()):
        print(f"build: {os.path.relpath(path, REPO)} in {secs:.2f} s", flush=True)
    runtimes = B.cuda_runtimes()
    print(f"CUDA runtimes in the process: {runtimes}", flush=True)
    if not runtimes["one_runtime"]:
        fail("the kernel library does not run on torch's CUDA runtime (one libcudart)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(CONFIG)
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        phase_s[name] = time.time() - t0
        return out

    sets = {"frame 0": timed("kernels frame 0", scene_kernel_phase, config, dev)}
    slam, gn_launches, snapshots = timed("rgbd gn slice", slice_phase, config, dev)
    sets.update(timed("kernels gn maps", map_kernel_phase, snapshots, slam.intr,
                      slam.raster_cfg, slam.step_cfg.mapping_rebin_dilation))
    del slam
    parity = timed("parity", parity_phase, dev)
    lab_launches, sets["lab"] = timed("lab", lab_phase, dev)
    mono, mono_snap, intr, rcfg, dilate = timed("mono", mono_phase, load_config(CONFIG), dev)
    sets.update(timed("kernels mono map", map_kernel_phase, [mono_snap], intr, rcfg, dilate))
    tum, euroc, thread, dp, ingest_launches, tum_snap = timed("ingest", ingest_phase, dev)
    phase_s["thread (in ingest)"] = thread["phase_s"]
    phase_s["dp (in ingest)"] = dp["phase_s"]
    replica, replica_launches = timed("replica", replica_phase, dev)
    _, replay_launches, replay_snap, r_intr, r_rcfg, r_dilate = timed(
        "replay", replay_phase, dev)
    sets.update(timed("kernels replay map", map_kernel_phase, [replay_snap], r_intr, r_rcfg,
                      r_dilate))
    _, scale_launches = timed("scale", scale_phase, dev)
    tum_cfg = load_config(TUM_CONFIG)
    cal = tum_cfg["Dataset"]["Calibration"]
    from monogs_dev_tpu_torch.core.params import StepConfig
    from monogs_dev_tpu_torch.core.system import raster_config_from
    from monogs_dev_tpu_torch.models.camera import Intrinsics

    tum_intr = Intrinsics(fx=float(cal["fx"]), fy=float(cal["fy"]), cx=float(cal["cx"]),
                          cy=float(cal["cy"]), width=int(cal["width"]),
                          height=int(cal["height"]))
    sets.update(timed("kernels tum map", map_kernel_phase, [tum_snap], tum_intr,
                      raster_config_from(tum_cfg),
                      StepConfig.from_config(tum_cfg).mapping_rebin_dilation))
    profiled = {"mono": mono["profile"], "parity": parity["profile"]}
    paths = {"rgbd_gn": gn_launches, "parity_adam": parity["launches"],
             "parity_eval": parity["eval_launches"], "mono_gn": mono["launches"],
             **ingest_launches, "replica": replica_launches, "replay": replay_launches,
             "scale": scale_launches}
    ksets = {label: k for label, (k, _) in sets.items()}
    lsets = {label: lab for label, (_, lab) in sets.items()}

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["K"],
            "replaces": REPLACES[name],
            "launches": parity["launches"][name],
            "launches_by_path": {path: n.get(name, 0) for path, n in paths.items()},
            "max_abs_err": max(res[name]["max_abs_err"] for res in ksets.values()),
            **set_times(ksets["frame 0"][name]),
            "library_ms": None,  # no single PyTorch call computes the blend
            "sets": {label: set_times(res[name]) for label, res in ksets.items()},
            **{f"{path}_device_ms_per_frame": (prof["kernel_ms_per_frame"][name]
                                                if prof else None)
               for path, prof in profiled.items()},
        }
        for name in ("K1", "K2", "K3")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES["L"],
            "replaces": REPLACES[name[:2]],
            "launches": n,
            "max_abs_err": max(res[name]["max_abs_err"] for res in lsets.values()),
            **set_times(lsets["lab"][name]),
            "library_ms": None,
            "sets": {label: set_times(res[name]) for label, res in lsets.items()},
        }
        for name, n in lab_launches.items()
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "monogs_dev_tpu_torch/csrc/project.cu",
            "replaces": None,  # XLA's fusion of the JAX package's jnp projection
            "launches": parity["launches"][name],
            "max_rel_err": (max(parity["projection"]["p1_rel_err"].values()) if name == "P1"
                            else parity["projection"]["p2_rel_err"]),
            **parity["projection"]["kernels"][name],
            "library_ms": None,
        }
        for name in ("P1", "P2")
    ]
    # K1-K3: launches in the parity run (phase 5; every path's under
    # launches_by_path: `thread` counts every thread's launches in the
    # thread-mode windows, `viewer` the viewer thread's alone); ms
    # (kernel-only), ms_v1
    # (the first version's, in turns with it), wrapper_ms, plain_ms and
    # bound_ms on the bench scene's frame-0 props (phase 3), and the same for
    # every prop set under "sets". L1/L2: launches in the lab's run, the same
    # numbers on the lab scene's props, and on every prop set under "sets".
    # max_abs_err over all sets. P1/P2: launches in the parity run, their
    # errors against the plain versions, ms, wrapper_ms (P1), plain_ms and
    # bound_ms on the parity run's map (`projection_check`).
    for label, (kres, lres) in sets.items():
        print(f"{label}: kernel-only speed-up over the first version: "
              + ", ".join(f"{k} {r['ms_v1'] / r['ms']:.2f}x"
                          for k, r in list(kres.items()) + list(lres.items())), flush=True)
        fastest = min((k for k in lres if k.startswith("L1/")), key=lambda k: lres[k]["ms"])
        print(f"{label}: lab answer, kernel-only: fastest L1 form {fastest} "
              f"{lres[fastest]['ms']:.4f} ms against K1 {kres['K1']['ms']:.4f} ms "
              f"({lres[fastest]['ms'] / kres['K1']['ms']:.2f}x; nocond "
              f"{lres['L1/nocond']['ms'] / kres['K1']['ms']:.2f}x); L2 {lres['L2']['ms']:.4f} ms "
              f"against K2 {kres['K2']['ms']:.4f} ms ({lres['L2']['ms'] / kres['K2']['ms']:.2f}x)",
              flush=True)
    print("phases (s): " + json.dumps(phase_s), flush=True)
    print(f"wall time: {time.time() - t_start:.1f} s", flush=True)
    # every thread the port or this script started has been joined: none may
    # run on into the interpreter's teardown
    alive = started_threads()
    if alive:
        fail(f"threads still alive at the end: {alive}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
