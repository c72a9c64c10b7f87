"""Host-side phase timers and the metrics log (port of `PhaseTimers` and
`MetricsLogger` in `monogs_dev_tpu/utils/profiling.py`). Times are host
wall clock; a caller that wants device time synchronizes the device first."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimers:
    """Accumulating host-side wall-clock timers keyed by phase name."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.tallies: Dict[str, int] = defaultdict(int)

    def tally(self, name: str, n: int = 1) -> None:
        """Unitless event counter, kept apart from the seconds-keyed timers."""
        self.tallies[name] += int(n)

    def snapshot(self) -> tuple:
        """Cheap copy of the running totals; pair with `delta_summary` to
        report a bounded window (e.g. the bench's steady-state segment)
        without the warmup/init-BA frames polluting the means."""
        return (dict(self.total), dict(self.count), dict(self.tallies))

    def delta_summary(self, snap: tuple) -> Dict[str, dict]:
        """Summary of activity since `snapshot()` (window-only split)."""
        t0, c0, y0 = snap
        out: Dict[str, dict] = {}
        for name in sorted(self.total):
            dt = self.total[name] - t0.get(name, 0.0)
            dc = self.count[name] - c0.get(name, 0)
            if dc or dt > 1e-9:
                out[name] = {
                    "total_s": round(dt, 4),
                    "count": dc,
                    "mean_ms": round(1000.0 * dt / max(dc, 1), 3),
                }
        for name in sorted(self.tallies):
            dy = self.tallies[name] - y0.get(name, 0)
            if dy:
                out[name] = {"count": dy}
        return out

    def summary(self) -> Dict[str, dict]:
        out = {
            name: {
                "total_s": round(self.total[name], 4),
                "count": self.count[name],
                "mean_ms": round(1000.0 * self.total[name] / max(self.count[name], 1), 3),
            }
            for name in sorted(self.total)
        }
        for name in sorted(self.tallies):
            out[name] = {"count": self.tallies[name]}
        return out


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
