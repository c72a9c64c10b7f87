"""Device (one H100): the share of the device's idle time in which a
session's host was in no span of the port's below `frame`, in %. The idle
time is the window less the union of every session's device intervals
(`breakdown.busy`), counted once a session; within it each session's
innermost open span record (the open record that started last) names what
its host did. Lower means the spans name what the hosts did while the card
waited. `idle_by_span` gives the idle seconds by that innermost span."""

import heapq
from typing import Dict, List, Optional

import numpy as np

from ..breakdown import busy
from ._spans import records

UNSPANNED = ("frame", None)  # a frame's own host work, or no span open


def _innermost(recs, t0: float, t1: float) -> List[tuple]:
    """[(start, end, name)] covering [t0, t1]: each piece labelled with the
    innermost open record (None where none is open)."""
    recs = sorted((a * 1e-9, b * 1e-9, name) for name, a, b, _, _ in recs)
    bounds = sorted({t0, t1} | {x for a, b, _ in recs for x in (a, b) if t0 < x < t1})
    heap: List[tuple] = []
    out: List[tuple] = []
    i = 0
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(recs) and recs[i][0] <= lo:
            a, b, name = recs[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] <= lo:
            heapq.heappop(heap)
        out.append((lo, hi, heap[0][2] if heap else None))
    return out


def _busy_before(merged: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The busy seconds of the sorted disjoint intervals `merged` before each
    time in t."""
    bs, dur = merged[:, 0], merged[:, 1] - merged[:, 0]
    cum = np.concatenate([[0.0], np.cumsum(dur)])
    i = np.searchsorted(bs, t, side="right")  # intervals that start by t
    j = np.maximum(i - 1, 0)
    part = np.clip(t - bs[j], 0.0, dur[j]) if len(bs) else np.zeros_like(t)
    return np.where(i > 0, cum[j] + part, 0.0)


def idle_by_span(ctx) -> Optional[Dict[Optional[str], float]]:
    """Idle seconds of the window by each session's innermost span name
    (None: no span open), summed over the sessions; None without a device
    trace or span records."""
    t0, t1 = ctx["start"], ctx["end"]
    merged = busy(ctx["sessions"], t0, t1)
    if merged is None or t1 <= t0:
        return None
    out: Dict[Optional[str], float] = {}
    for s in ctx["sessions"]:
        recs = records(s)
        if recs is None:
            return None
        pieces = _innermost(recs, t0, t1)
        lo = np.array([p[0] for p in pieces])
        hi = np.array([p[1] for p in pieces])
        idle = (hi - lo) - (_busy_before(merged, hi) - _busy_before(merged, lo))
        for (_, _, name), sec in zip(pieces, idle.tolist()):
            if sec > 0:
                out[name] = out.get(name, 0.0) + sec
    return out


def read(ctx):
    by = idle_by_span(ctx)
    if by is None:
        return None
    total = sum(by.values())
    if total <= 0:
        return None
    return 100.0 * sum(by.get(name, 0.0) for name in UNSPANNED) / total
