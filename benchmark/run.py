"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`benchmark/configs/<name>.json`) and a traffic mix
(`benchmark/traffic/<name>.json`); each per-layer metric is read by
`benchmark/metrics/<name>.py`. The run starts one process per session
(`session.py`): each makes its sequence from the seed, sets up the port's
`SLAM` on it and waits; all start their windows together, and once every
window has closed each checks what its window produced against the plain
reference. This process touches the card only to ask for it; it prints the
compared numbers beside their limits on stderr and, as the last line of
stdout, the result JSON. Without a CUDA card, or with fewer than the cell
asks for, it exits 1 and prints no result.

Everything a run writes stays inside the checkout: the port builds its
kernels into `monogs_dev_tpu_torch/build/` (once a checkout), and each run
writes its sessions' sequences anew into `benchmark/.cache/<cell>/s<k>/`.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up counts from here, before any import

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PORT = "monogs_dev_tpu_torch"
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
SETUP_TIMEOUT_S = 900.0
RESULT_TIMEOUT_S = 900.0


def load_cell(workload: str, root: str = ROOT) -> Dict:
    """The cell's entries: workload, config file, traffic file and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = load_files(os.path.splitext(os.path.basename(conf["file"]))[0], w["traffic"])
    cell["workload"] = w
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if workload in m.get("workloads", [workload])]
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload])]
    return cell


def load_files(config: str, traffic: str) -> Dict:
    """A configuration and a traffic mix by their files' names, as a cell
    of one card with no metrics."""
    with open(os.path.join(BENCH_DIR, "configs", config + ".json")) as f:
        conf = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    return {"workload": {"name": f"{config}.{traffic}", "chips": 1}, "config": conf,
            "traffic": mix, "end_to_end": [], "per_layer": []}


def reader(name: str):
    """`benchmark/metrics/<name>.py::read`, or None if there is none."""
    try:
        return importlib.import_module(f"benchmark.metrics.{name}").read
    except ModuleNotFoundError:
        return None


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card, if it answers."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def _session_main(cell, k, seed, seconds, trace, cache_root, ready, closed, results,
                  control, fault):
    """Entry point of a session process: its stdout goes to stderr, so that
    the parent's result line is the last line of stdout. A session's host
    work runs on one thread (torch's and the BLAS pools at 1): S sessions
    on the machine's cores, none oversubscribed."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    for var in THREAD_VARS:
        os.environ[var] = "1"
    try:
        import torch

        torch.set_num_threads(1)
        torch.set_num_interop_threads(1)
        from benchmark import faults
        from benchmark.session import run_session

        out = run_session(cell, k, seed=seed, seconds=seconds, trace=trace, device="cuda",
                          cache_root=cache_root, start=lambda: ready.wait(SETUP_TIMEOUT_S),
                          closed=lambda: closed.wait(RESULT_TIMEOUT_S), control=control,
                          fault=getattr(faults, fault) if fault else None)
        results.put((k, "ok", out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the run
        results.put((k, "error", traceback.format_exc()))
        ready.abort()
        closed.abort()
        raise


def run_sessions(cell: Dict, seed: int, seconds: float, trace: bool, control: bool = False,
                 fault: Optional[str] = None):
    """Start the sessions, wait for their set-up; returns (set-up end time,
    the sessions' results in order)."""
    import multiprocessing as mp
    import threading

    n = int(cell["traffic"]["sessions"])
    cache_root = os.path.join(BENCH_DIR, ".cache", cell["workload"]["name"])
    ctx = mp.get_context("spawn")
    ready, closed = ctx.Barrier(n + 1), ctx.Barrier(n)
    results = ctx.Queue()
    procs = [ctx.Process(target=_session_main, name=f"session{k}",
                         args=(cell, k, seed, seconds, trace, cache_root, ready, closed, results,
                               control, fault)) for k in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, tuple] = {}
    t_ready: List[float] = []
    waiter = threading.Thread(target=lambda: t_ready.append(_wait(ready)), daemon=True)
    waiter.start()
    try:
        deadline = time.time() + SETUP_TIMEOUT_S + RESULT_TIMEOUT_S
        while len(got) < n:
            try:
                k, status, out = results.get(timeout=max(1.0, deadline - time.time()))
            except Exception as exc:  # queue.Empty: a session hung or died unreported
                raise RuntimeError(f"sessions {sorted(set(range(n)) - set(got))} gave no "
                                   "result") from exc
            if status != "ok":
                raise RuntimeError(f"session {k} failed:\n{out}")
            got[k] = out
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ready.abort()
        waiter.join(timeout=5)
    if not t_ready or t_ready[0] is None:
        raise RuntimeError("the sessions did not meet at the start")
    return t_ready[0], [got[k] for k in range(n)]


def _wait(barrier) -> Optional[float]:
    """The time when every session has met the start, or None if one
    failed."""
    try:
        barrier.wait(SETUP_TIMEOUT_S)
        return time.time()
    except Exception:  # threading.BrokenBarrierError: a session failed
        return None


def window(sessions: List[Dict], seconds: float):
    """(start, end, frames): the measured window runs from the common start
    for `seconds`, or until the first session runs out of frames, and
    counts every frame that ended inside it (a frame in flight at its end
    is run to its end and not counted)."""
    start = min(s["t0"] for s in sessions)
    end = min([start + seconds] + [s["frame_end"][-1] for s in sessions
                                    if s["ran_out"] and s["frame_end"]])
    frames = sum(1 for s in sessions for e in s["frame_end"] if e <= end)
    return start, end, frames


def end_to_end(sessions: List[Dict], setup_s: float, seconds: float) -> Dict[str, float]:
    from benchmark.session import ate_cm

    start, end, frames = window(sessions, seconds)
    return {"frames_per_s": frames / (end - start), "ate_cm": ate_cm(sessions),
            "setup_s": setup_s}


def verdict(sessions: List[Dict], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit, at its worst over the run:
    ate_cm, the worst session's (the configuration's bar); every other
    number, the worst of the sessions' readings (render_mae, grad_rel: the
    sampled renders and pose gradients; map_depth_cm, map_color_mae: the
    map at the window's end, at each keyframe checked)."""
    from benchmark.session import ate_cm

    got = {"ate_cm": max(ate_cm([s]) for s in sessions)}
    for name in limits:
        if name != "ate_cm":
            vals = [v for s in sessions for v in s["checks"].get(name, [])]
            got[name] = max(vals) if vals else math.inf
    return {k: {"value": got[k], "limit": float(limits[k])} for k in limits}


def result_of(cell: Dict, sessions: List[Dict], setup_s: float, seconds: float, trace: bool,
              kind: str) -> Dict:
    """The result line of a run from its sessions' numbers: the cell's
    end-to-end metrics (or, traced, its per-layer metrics), the device,
    `correct` and, last, each compared number beside its limit."""
    checks = verdict(sessions, cell["config"]["limits"])
    start, end, _ = window(sessions, seconds)
    if trace:
        from benchmark import breakdown

        ctx = {"sessions": sessions, "start": start, "end": end,
               "device": breakdown.summary(sessions, start, end)}
        metrics = {}
        for m in cell["per_layer"]:
            fn = reader(m["name"])
            v = fn(ctx) if fn is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(sessions, setup_s, seconds)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] in e2e}
    device = {"platform": "gpu", "kind": kind, "count": int(cell["workload"]["chips"]),
              "memory_peak_bytes": sum(s["memory_peak_bytes"] for s in sessions)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": sum(s["frames"] for s in sessions),
              "failed": sum(s["failed_frames"] for s in sessions), "metrics": metrics,
              "device": device}
    if trace:
        busy_s, window_s, bd = ctx["device"]
        if busy_s is not None:
            device.update(busy_s=busy_s, window_s=window_s)
            result["breakdown"] = bd
    result["info"] = {"frames": [s["frames"] for s in sessions],
                      "window_s": [s["t_end"] - s["t0"] for s in sessions],
                      "setup_s": setup_s, "mapping": [s["mapping"] for s in sessions]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the control (the reference at TF32) in the port's place in the "
                         "render and gradient checks; for the limits' readings, never in a "
                         "benchmark run")
    ap.add_argument("--fault", choices=("map_unchanged",),
                    help="plant a fault of benchmark/faults.py in the port for the window; "
                         "for the limits' readings, never in a benchmark run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs the port on a card", file=sys.stderr)
        return 1
    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 1
    if importlib.util.find_spec(PORT) is None:
        print(f"the port ({PORT}) is not in this checkout", file=sys.stderr)
        return 1
    # built once here, not by every session at once
    from monogs_dev_tpu_torch.data import image_io, jpeg
    from monogs_dev_tpu_torch.ops import blend

    blend.build()
    image_io.build()
    jpeg.build()

    t_ready, sessions = run_sessions(cell, args.seed, args.seconds, bool(args.trace),
                                     args.control, args.fault)
    setup_s = t_ready - T_START
    from benchmark.session import forbidden_modules

    found = sorted(set(sum((s["forbidden"] for s in sessions), [])) | set(forbidden_modules()))
    if found:
        print(f"modules that the run may not load were loaded: {found}", file=sys.stderr)
        return 1
    result = result_of(cell, sessions, setup_s, args.seconds, bool(args.trace),
                       torch.cuda.get_device_name(0))
    result["device"]["card"] = card_line()
    print(f"setup_s {setup_s!r}; per session " + json.dumps(
        [dict(s["setup"], **s["post"]) for s in sessions]), file=sys.stderr)
    print(f"wall_s {time.time() - T_START!r}", file=sys.stderr)
    print("readings " + json.dumps({"checks": [s["checks"] for s in sessions],
                                    "program_checks": [s.get("program_checks")
                                                       for s in sessions],
                                    "checked_frames": [s["checked_frames"] for s in sessions],
                                    "map_detail": [s["map_detail"] for s in sessions]}),
          file=sys.stderr)
    for k, c in result["checks"].items():  # the last lines of stderr
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
