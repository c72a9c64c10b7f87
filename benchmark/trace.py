"""What a `--trace 1` run records in a session, and how it is read.

- `torch.profiler` with CUDA activity only, over the window: every device
  operation's interval (for the device's busy and idle time, merged here
  into their union) and the device seconds of each kernel by name.
- Host spans, by wrappers installed for the traced window only:
  `FrontEnd.tracking` (tracking), `FrontEnd._fetch_frame` (fetch) and
  `BackendEngine.map` (mapping), on the host clock.
- A sample of the blend's launches (`ops/blend.py::blend_forward_cuda` and
  `blend_backward_cuda`, every SAMPLE_EVERY-th of each): the launch's
  device tensors are kept (no host read in the window) and, after it, the
  least time of that launch (`yardstick.bound`) is set against the device
  time of the same launch in the trace (launches and kernels of one name
  are matched in order; one stream a process).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import yardstick

SAMPLE_EVERY = 97  # every 97th forward and backward launch of the blend
FWD_KERNEL, BWD_KERNEL = "blend_fwd_kernel", "blend_bwd_kernel"


def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The union of intervals [starts[i], ends[i]], as an (n, 2) array of
    sorted disjoint intervals (numpy: a window holds ~1e6 kernels)."""
    if len(starts) == 0:
        return np.zeros((0, 2))
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts, np.float64)[order], np.asarray(ends, np.float64)[order]
    reach = np.maximum.accumulate(e)
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] > reach[:-1]
    heads = np.nonzero(first)[0]
    tails = np.append(heads[1:] - 1, len(s) - 1)
    return np.stack([s[heads], reach[tails]], axis=1)


class Tracer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.spans: List[tuple] = []
        self.fwd: List[dict] = []
        self.bwd: List[dict] = []
        self.n_fwd = self.n_bwd = 0
        self.recent: Dict[int, torch.Tensor] = {}
        self.prof = None
        self.wall0 = self.mono0 = 0.0
        self.tracing = False
        self._undo: List[tuple] = []

    # ------------------------------------------------------------ wrappers
    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def _span(self, label):
        def make(orig):
            def wrapped(*args, **kwargs):
                a = time.time()
                try:
                    return orig(*args, **kwargs)
                finally:
                    self.spans.append((label, a, time.time()))
            return wrapped
        return make

    def _fwd(self, orig):
        def wrapped(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, emit_touch):
            out = orig(props, counts, tx_n, tile, alpha_clamp, alpha_min, t_min, emit_touch)
            self.recent[props.data_ptr()] = counts
            if len(self.recent) > 256:
                self.recent.pop(next(iter(self.recent)))
            if self.n_fwd % SAMPLE_EVERY == 0:
                self.fwd.append({"i": self.n_fwd, "name": "K3" if emit_touch else "K1",
                                 "props": props, "counts": counts, "n_done": out[4],
                                 "args": (tx_n, tile, alpha_clamp, alpha_min, t_min)})
            self.n_fwd += 1
            return out
        return wrapped

    def _bwd(self, orig):
        def wrapped(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile, alpha_clamp,
                    alpha_min):
            out = orig(props, t_final, n_done, g_color, g_depth, g_alpha, tx_n, tile,
                       alpha_clamp, alpha_min)
            if self.n_bwd % SAMPLE_EVERY == 0:
                self.bwd.append({"i": self.n_bwd, "name": "K2", "props": props,
                                 "counts": self.recent.get(props.data_ptr()), "n_done": n_done,
                                 "args": (tx_n, tile, alpha_clamp, alpha_min, None)})
            self.n_bwd += 1
            return out
        return wrapped

    def start(self) -> None:
        from monogs_dev_tpu_torch.core.backend import BackendEngine
        from monogs_dev_tpu_torch.core.frontend import FrontEnd
        from monogs_dev_tpu_torch.ops import blend

        self._patch(FrontEnd, "tracking", self._span("tracking"))
        self._patch(FrontEnd, "_fetch_frame", self._span("fetch"))
        self._patch(BackendEngine, "map", self._span("mapping"))
        self._patch(blend, "blend_forward_cuda", self._fwd)
        self._patch(blend, "blend_backward_cuda", self._bwd)
        if self.device.type == "cuda":
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.tracing = True
        self.wall0, self.mono0 = time.time(), time.monotonic()

    def stop(self) -> None:
        """End the trace and take the wrappers out (a second call does
        nothing)."""
        if self.tracing:
            torch.cuda.synchronize(self.device)
            self.prof.__exit__(None, None, None)
            self.tracing = False
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    # -------------------------------------------------------------- reading
    def _device_events(self):
        """(names, name ids, starts, ends) of every device operation, on the
        host's wall clock (s), in start order; None without a trace."""
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        ids: Dict[str, int] = {}
        rows = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == cuda:
                rows.append((ids.setdefault(ev.name(), len(ids)), ev.start_ns(),
                             ev.duration_ns()))
        names = list(ids)
        if not rows:
            return names, np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
        arr = np.asarray(rows, np.float64)
        st = arr[:, 1] * 1e-9
        if abs(st.min() - self.wall0) < 3600.0:
            shift = 0.0
        elif abs(st.min() - self.mono0) < 3600.0:
            shift = self.wall0 - self.mono0
        else:
            return None
        order = np.argsort(st, kind="stable")
        st = st[order] + shift
        return names, arr[order, 0].astype(np.int64), st, st + arr[order, 2] * 1e-9

    def _roofline(self, samples: List[dict], durations: List[float], t0: float, t1: float):
        """{bound_ms, device_ms, n} over the sampled launches of one kernel
        whose device interval lies in the window."""
        bound_ms = device_ms = 0.0
        n = 0
        for smp in samples:
            i = smp["i"]
            if i >= len(durations) or smp["counts"] is None:
                continue
            start, end = durations[i]
            if start < t0 or end > t1:
                continue
            tx_n, tile, clamp, amin, tmin = smp["args"]
            tw, th = tile if isinstance(tile, tuple) else (tile, tile)
            touch = yardstick.touch_counts(smp["props"], smp["counts"], tx_n, (tw, th), clamp,
                                           amin, 1e-4 if tmin is None else tmin)
            b, _ = yardstick.bound(smp["name"], smp["counts"], smp["n_done"], touch, tw * th)
            bound_ms += b
            device_ms += 1e3 * (end - start)
            n += 1
        return {"bound_ms": bound_ms, "device_ms": device_ms, "n": n}

    def result(self, t0: float, t1: float) -> Dict:
        """The session's trace numbers for the window [t0, t1] (host clock)."""
        out: Dict = {"spans": [(n, a, b) for n, a, b in self.spans if b > t0 and a < t1]}
        evs = self._device_events()
        if evs is None:
            out["device"] = None
            return out
        names, ids, st, en = evs
        a, b = np.maximum(st, t0), np.minimum(en, t1)
        inside = b > a
        secs = np.bincount(ids[inside], weights=(b - a)[inside], minlength=len(names))
        by_name = {n: float(secs[i]) for i, n in enumerate(names) if secs[i] > 0}

        def of(kernel):
            is_k = np.isin(ids, [i for i, n in enumerate(names) if kernel in n])
            return list(zip(st[is_k], en[is_k]))

        fwd, bwd = of(FWD_KERNEL), of(BWD_KERNEL)
        k1 = [s for s in self.fwd if s["name"] == "K1"]
        matched = len(fwd) == self.n_fwd and len(bwd) == self.n_bwd
        out["device"] = {
            "busy": merge(a[inside], b[inside]), "by_name": by_name, "n_events": len(ids),
            "launches_matched": matched,
            "K1": self._roofline(k1, fwd, t0, t1) if matched else None,
            "K2": self._roofline(self.bwd, bwd, t0, t1) if matched else None,
        }
        self.fwd.clear()
        self.bwd.clear()
        self.recent.clear()
        return out
