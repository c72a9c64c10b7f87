"""The readers of the port's spans and counters (`raster_ms_per_frame`,
`backward_ms_per_adam_iter`, `syncs_per_adam_iter`, `sync_wait_ms_per_frame`,
`map_ms_per_iter`, `idle_unspanned_pct`) on a hand-built `ctx` of two
sessions with known timers, span records, device intervals and frames: each
returns its known value, and None where the spans it reads are missing (a
program without them, or a window without a trace)."""

import numpy as np
import pytest

from benchmark import run
from benchmark.metrics import idle_unspanned_pct

NEW = ("raster_ms_per_frame", "backward_ms_per_adam_iter", "syncs_per_adam_iter",
       "sync_wait_ms_per_frame", "map_ms_per_iter", "idle_unspanned_pct")


def _ns(t):
    return int(round(t * 1e9))


def _rec(name, a, b, parent, thread):
    return (name, _ns(a), _ns(b), parent, thread)


def _timer(total, self_s=None):
    return {"total_s": total, "count": 1, "mean_ms": 1e3 * total,
            "self_s": total if self_s is None else self_s}


def _ctx():
    """Two sessions over the window [1000, 1010] s. Session a: a frame
    [1000, 1006] holding tracking [1000.5, 1005] with a sync at its end;
    syncs on its thread at 110-111 and 150-160 s lie in a tracking span of
    [100, 200], those at 210 s and on another thread do not: 3 inside.
    Session b: a pump from 999 s holding an idle round [1000, 1004], then a
    frame to past the window; of its syncs, two lie inside its tracking
    spans."""
    a_recs = [_rec("frame", 1000.0, 1006.0, None, 1),
              _rec("tracking", 1000.5, 1005.0, "frame", 1),
              _rec("sync.stop", 1004.5, 1005.0, "tracking", 1),
              _rec("tracking", 100.0, 200.0, None, 1),
              _rec("sync.stop", 110.0, 111.0, "tracking", 1),
              _rec("sync.readback", 150.0, 160.0, "tracking", 1),
              _rec("sync.run_end", 210.0, 220.0, None, 1),
              _rec("sync.batch", 120.0, 130.0, None, 2)]
    b_recs = [_rec("pump", 999.0, 1004.2, None, 7),
              _rec("round.idle", 1000.0, 1004.0, "pump", 7),
              _rec("frame", 1004.2, 1010.5, None, 7),
              _rec("tracking", 0.0, 50.0, None, 7),
              _rec("tracking", 60.0, 100.0, None, 7),
              _rec("sync.stop", 10.0, 20.0, "tracking", 7),
              _rec("sync.tier", 55.0, 58.0, None, 7),
              _rec("sync.stop", 70.0, 80.0, "tracking", 7),
              _rec("sync.readback", 90.0, 101.0, None, 7)]
    a = {"frames": 2, "mapping": {"map_iters": 12},
         "trace": {"device": {"busy": np.array([[1001.0, 1003.0]])}},
         "timers": {"project": _timer(0.010, 0.008), "bin": _timer(0.005, 0.004),
                    "render": _timer(0.5), "track.backward": _timer(0.03),
                    "tracking_iters": {"count": 10}, "sync.stop": _timer(0.002),
                    "sync.readback": _timer(0.001), "round.idle": _timer(0.02),
                    "round.keyframe": _timer(0.1), "pump": _timer(0.3),
                    "spans": {"clock": "unix_ns", "records": a_recs}}}
    b = {"frames": 3, "mapping": {"map_iters": 8},
         "trace": {"device": {"busy": np.array([[1002.0, 1004.0], [1008.0, 1009.0]])}},
         "timers": {"project": _timer(0.015, 0.012), "bin": _timer(0.006),
                    "track.backward": _timer(0.06), "tracking_iters": {"count": 20},
                    "sync.stop": _timer(0.003), "round.idle": _timer(0.04),
                    "spans": {"clock": "unix_ns", "records": b_recs}}}
    return {"sessions": [a, b], "start": 1000.0, "end": 1010.0, "device": (None, None, None)}


WANT = {
    "raster_ms_per_frame": 1e3 * (0.008 + 0.004 + 0.012 + 0.006) / 5,
    "backward_ms_per_adam_iter": 1e3 * (0.03 + 0.06) / 30,
    "syncs_per_adam_iter": (3 + 2) / 30,
    "sync_wait_ms_per_frame": 1e3 * (0.002 + 0.001 + 0.003) / 5,
    "map_ms_per_iter": 1e3 * (0.02 + 0.1 + 0.04) / 20,
    # idle: [1000, 1001], [1004, 1008], [1009, 1010], 6 s a session; a is in
    # a frame or no span 4.5 s of it, b 4.8 s
    "idle_unspanned_pct": 100.0 * (4.5 + 4.8) / 12.0,
}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_its_known_value(name):
    assert run.reader(name)(_ctx()) == pytest.approx(WANT[name], rel=1e-9)


def test_idle_seconds_by_innermost_span():
    got = idle_unspanned_pct.idle_by_span(_ctx())
    want = {"frame": 1.5 + 4.8, "tracking": 1.0, "sync.stop": 0.5, None: 3.0,
            "round.idle": 1.0, "pump": 0.2}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k


def _without_spans(ctx):
    """The parent's program: timers of tracking, fetch and iterations only,
    no span records."""
    for s in ctx["sessions"]:
        s["timers"] = {"tracking": _timer(1.0), "fetch_frame": _timer(0.1),
                       "tracking_iters": {"count": 10}}
    return ctx


def _without_records(ctx):
    """Spans, but a window outside a trace: the totals without records."""
    for s in ctx["sessions"]:
        del s["timers"]["spans"]
    return ctx


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_none_without_its_spans(name):
    assert run.reader(name)(_without_spans(_ctx())) is None
    ctx = _ctx()
    for s in ctx["sessions"]:
        s.pop("timers")
    assert run.reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["syncs_per_adam_iter", "idle_unspanned_pct"])
def test_record_readers_give_none_outside_a_trace(name):
    assert run.reader(name)(_without_records(_ctx())) is None


def test_idle_share_gives_none_without_a_device_trace():
    ctx = _ctx()
    for s in ctx["sessions"]:
        s["trace"] = {"device": None}
    assert idle_unspanned_pct.read(ctx) is None
    assert idle_unspanned_pct.idle_by_span(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_one_session_without_spans_leaves_the_metric_out(name):
    ctx = _ctx()
    ctx["sessions"][1] = _without_spans({"sessions": [ctx["sessions"][1]]})["sessions"][0]
    assert run.reader(name)(ctx) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_idle_by_span_against_a_fine_grid(seed):
    """Random device intervals and nested records of two threads: the idle
    seconds by innermost span equal a count over a 1 ms grid of the window."""
    rng = np.random.default_rng(seed)
    t0, t1 = 500.0, 510.0
    st = np.sort(rng.uniform(t0 - 1.0, t1, 400))
    busy_iv = np.stack([st, st + rng.exponential(0.01, 400)], 1)
    recs = []
    for thread in (1, 2):
        t = t0 - 0.5
        while t < t1 + 0.5:
            a, b = t, t + rng.uniform(0.05, 0.3)
            recs.append(_rec("outer", a, b, None, thread))
            m = a + (b - a) * rng.uniform(0.1, 0.4)
            recs.append(_rec("inner%d" % thread, m, m + (b - m) * 0.5, "outer", thread))
            t = b + rng.uniform(0.0, 0.1)
    ctx = {"sessions": [{"trace": {"device": {"busy": busy_iv}},
                         "timers": {"spans": {"records": recs}}}], "start": t0, "end": t1}
    got = idle_unspanned_pct.idle_by_span(ctx)
    grid = np.arange(t0, t1, 1e-3) + 5e-4
    is_busy = np.zeros(len(grid), bool)
    for a, b in busy_iv:
        is_busy |= (grid >= a) & (grid < b)
    want = {}
    for t in grid[~is_busy]:
        open_ = [(r[1], r[0]) for r in recs if r[1] * 1e-9 <= t < r[2] * 1e-9]
        name = max(open_)[1] if open_ else None
        want[name] = want.get(name, 0.0) + 1e-3
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=0.02), k
