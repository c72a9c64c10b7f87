"""Host-side spans, counters and the metrics log (port of `PhaseTimers` and
`MetricsLogger` in `monogs_dev_tpu/utils/profiling.py`, with nested spans).

`PhaseTimers` is the port's one recorder. A span (`span(name)`) is a
context manager with one stack per thread; on close it adds its time to
`total[name]`, its time less its direct children's to `self_s[name]` and one
to `count[name]`. A sync (`sync(site)`) is a span named `sync.<site>` around
a call that makes the host wait for the device; it also counts one in the
`syncs` tally. Times are host wall clock from `now_ns`, the clock that
torch's profiler stamps its host events with. While a torch profiler is
active each span is also kept as a record `(name, start_ns, end_ns, parent,
thread)`; outside a profiler window only the totals are kept.

The module keeps one active recorder (`activate`; `SLAM` makes its own
active), so that the functions of `ops/`, `core/`, `geometry/` and
`models/` open spans (`span`, `sync`, `spanned`) without a parameter for
it. A caller that wants device time synchronizes the device first."""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

from torch.autograd import profiler as _torch_profiler

# torch's profiler stamps host events on the Unix epoch in ns
now_ns = time.time_ns


class _Span:
    __slots__ = ("timers", "name", "apart", "start", "child_ns", "apart_ns", "n_syncs")

    def __init__(self, timers: "PhaseTimers", name: str, apart: bool, n_syncs: int):
        self.timers, self.name, self.apart, self.n_syncs = timers, name, apart, n_syncs
        self.child_ns = self.apart_ns = 0

    def __enter__(self):
        self.timers._stack().append(self)
        self.start = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = now_ns()
        t = self.timers
        stack = t._stack()
        stack.pop()
        dur = end - self.start
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += dur
            if self.apart:
                parent.apart_ns += dur
        name = self.name
        with t._lock:
            t.total[name] += (dur - self.apart_ns) * 1e-9
            t.self_s[name] += (dur - self.child_ns) * 1e-9
            t.count[name] += 1
            if self.n_syncs:
                t.tallies["syncs"] += self.n_syncs
            if _torch_profiler._is_profiler_enabled:
                t.records.append((name, self.start, end, parent.name if parent else None,
                                  threading.get_ident()))
        return False


class PhaseTimers:
    """Accumulating host-side wall-clock spans keyed by name, with tallies."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.self_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.tallies: Dict[str, int] = defaultdict(int)
        self.records: list = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, apart: bool = False) -> _Span:
        """A span named `name`. With `apart`, its time is left out of the
        enclosing span's total (work of another phase run inside that one,
        such as the next frame's fetch inside tracking); the enclosing
        span's record still covers it."""
        return _Span(self, name, apart, 0)

    def sync(self, site: str) -> _Span:
        """A span named `sync.<site>` around one call that makes the host
        wait for the device; it counts one in the `syncs` tally."""
        return _Span(self, "sync." + site, False, 1)

    def tally(self, name: str, n: int = 1) -> None:
        """Unitless event counter, kept apart from the seconds-keyed timers."""
        with self._lock:
            self.tallies[name] += int(n)

    def snapshot(self) -> tuple:
        """Cheap copy of the running totals; pair with `delta_summary` to
        report a bounded window (e.g. the bench's steady-state segment)
        without the warmup/init-BA frames polluting the means."""
        return (dict(self.total), dict(self.count), dict(self.tallies), dict(self.self_s),
                len(self.records))

    def _since(self, snap: tuple) -> Dict[str, dict]:
        t0, c0, y0, s0, _ = snap
        out: Dict[str, dict] = {}
        for name in sorted(self.total):
            dt = self.total[name] - t0.get(name, 0.0)
            dc = self.count[name] - c0.get(name, 0)
            if dc or dt > 1e-9:
                out[name] = {
                    "total_s": round(dt, 4),
                    "count": dc,
                    "mean_ms": round(1000.0 * dt / max(dc, 1), 3),
                    "self_s": round(self.self_s[name] - s0.get(name, 0.0), 4),
                }
        for name in sorted(self.tallies):
            dy = self.tallies[name] - y0.get(name, 0)
            if dy:
                out[name] = {"count": dy}
        return out

    def delta_summary(self, snap: tuple) -> Dict[str, dict]:
        """Summary of activity since `snapshot()` (window-only split); with
        the records kept since then, if any, under "spans"."""
        out = self._since(snap)
        records = self.records[snap[4]:]
        if records:
            out["spans"] = {"clock": "unix_ns", "records": records}
        return out

    def summary(self) -> Dict[str, dict]:
        return self._since(({}, {}, {}, {}, 0))


_active = PhaseTimers()  # until a SLAM makes its own active


def activate(timers: PhaseTimers) -> None:
    """Make `timers` the recorder that `span`, `sync` and `tally` write to."""
    global _active
    _active = timers


def active() -> PhaseTimers:
    return _active


def span(name: str, apart: bool = False) -> _Span:
    """A span of the active recorder (`PhaseTimers.span`)."""
    return _active.span(name, apart)


def sync(site: str) -> _Span:
    """A sync of the active recorder (`PhaseTimers.sync`)."""
    return _active.sync(site)


def tally(name: str, n: int = 1) -> None:
    _active.tally(name, n)


def spanned(name: str):
    """Decorator: every call of the function is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _active.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class MetricsLogger:
    """JSONL metrics stream in the run directory, optionally mirrored to
    wandb (`Results.use_wandb`, best-effort: without the package or a
    network the JSONL file is the only sink). Tables are also written as
    markdown files in the run directory."""

    def __init__(self, save_dir: Optional[str], use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self.save_dir = save_dir
        self.path = os.path.join(save_dir, "metrics.jsonl") if save_dir is not None else None
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception as exc:  # ImportError or a failed init
                from .logging import Log

                Log(f"wandb unavailable ({exc}); JSONL metrics only")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        record = dict(metrics)
        if step is not None:
            record["step"] = step
        if self._wandb is not None:
            self._wandb.log(record, step=step)
        if self.path is None:
            return
        record["ts"] = time.time()
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def log_table(self, name: str, columns: list, rows: list) -> None:
        """A Before/After-style metrics table, as <name>_table.md."""
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Table(columns=columns, data=rows)})
        if self.save_dir is None:
            return
        with open(os.path.join(self.save_dir, f"{name.lower()}_table.md"), "w",
                  encoding="utf-8") as f:
            f.write("| " + " | ".join(columns) + " |\n")
            f.write("|" + "---|" * len(columns) + "\n")
            for row in rows:
                cells = [f"{v:.4f}" if isinstance(v, float) else str(v) for v in row]
                f.write("| " + " | ".join(cells) + " |\n")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
