"""The device's busy time over a traced window, pooled over the sessions
(one card, one host clock), and the breakdown that the result line carries:
the device operations that took most time, and the longest idle gaps named
by what the sessions' hosts were doing then (their spans: tracking, fetch,
mapping)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .trace import merge

TOP = 10


def busy(sessions: List[Dict], t0: float, t1: float) -> Optional[np.ndarray]:
    """The union of every session's device intervals inside [t0, t1], as an
    (n, 2) array, or None without a trace."""
    devs = [s.get("trace", {}).get("device") for s in sessions]
    if any(d is None for d in devs):
        return None
    iv = np.concatenate([d["busy"] for d in devs])
    a, b = np.maximum(iv[:, 0], t0), np.minimum(iv[:, 1], t1)
    keep = b > a
    return merge(a[keep], b[keep])


def _host_label(sessions: List[Dict], t: float) -> str:
    names = sorted({n for s in sessions for n, a, b in s["trace"]["spans"] if a <= t < b})
    return "+".join(names) if names else "between spans"


def summary(sessions: List[Dict], t0: float, t1: float):
    """(busy seconds, window seconds, breakdown) of the window [t0, t1], or
    (None, None, None) without a trace. Device seconds by name are the
    sessions' over their own windows."""
    merged = busy(sessions, t0, t1)
    if merged is None:
        return None, None, None
    busy_s = float((merged[:, 1] - merged[:, 0]).sum())
    lo = np.append(t0, merged[:, 1])  # each gap runs from a busy end to the next start
    hi = np.append(merged[:, 0], t1)
    length = hi - lo
    top = np.argsort(-length, kind="stable")[:TOP]
    gaps = [(float(length[i]), 0.5 * float(lo[i] + hi[i])) for i in top if length[i] > 0]
    by_name: Dict[str, float] = {}
    for s in sessions:
        for name, sec in s["trace"]["device"]["by_name"].items():
            by_name[name] = by_name.get(name, 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return busy_s, t1 - t0, {
        "device_ops": [[name[:120], sec] for name, sec in ops],
        "idle_gaps": [[_host_label(sessions, mid), gap] for gap, mid in gaps[:TOP]],
    }
