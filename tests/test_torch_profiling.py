"""The port's recorder (`utils/profiling.py::PhaseTimers`) and the span tree
that a tracked frame and a mapping round leave in it, on the CPU.

The recorder: nesting and self time, one stack per thread, spans closed on
an exception, records kept only inside a torch profiler window, its clock
shared with the profiler's host events, and a span `apart` (the frontend's
prefetch) left out of its parent's total. The slice: two frames of the
tiny RGB-D config with the inline backend pump (each an idle mapping round,
then the Adam tracker) inside a profiler window; its records hold one
`track.iter` and one `sync.stop` an Adam iteration, a `project` under every
`track.iter` and `map.iter`, and `tracking` less the next frame's prefetch
inside it equals the `tracking` timer."""

import os
import threading

import pytest
import torch

from monogs_dev_tpu_torch.utils import profiling
from monogs_dev_tpu_torch.utils.profiling import PhaseTimers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clock(monkeypatch):
    """A clock that moves only when told (ns)."""
    now = [1_000]
    monkeypatch.setattr(profiling, "now_ns", lambda: now[0])

    def advance(ns):
        now[0] += ns
    return advance


def test_nesting_and_self_time(clock):
    t = PhaseTimers()
    with t.span("outer"):
        clock(100)
        with t.span("inner"):
            clock(30)
            with t.sync("wait"):
                clock(5)
        clock(20)
        with t.span("inner"):
            clock(10)
    assert t.total["outer"] == pytest.approx(165e-9)
    assert t.self_s["outer"] == pytest.approx(120e-9)
    assert t.total["inner"] == pytest.approx(45e-9) and t.count["inner"] == 2
    assert t.self_s["inner"] == pytest.approx(40e-9)
    assert t.total["sync.wait"] == pytest.approx(5e-9) and t.tallies["syncs"] == 1
    summary = t.summary()
    assert summary["outer"]["count"] == 1 and summary["syncs"] == {"count": 1}
    assert set(summary["inner"]) == {"total_s", "count", "mean_ms", "self_s"}


def test_a_span_apart_is_left_out_of_its_parents_total(clock):
    """The frontend's prefetch: `tracking` counts its own time only, its
    record still covers the fetch inside it."""
    t = PhaseTimers()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with t.span("frame"):
            with t.span("tracking"):
                clock(300)
                with t.span("fetch_frame", apart=True):
                    clock(70)
                clock(30)
    assert t.total["tracking"] == pytest.approx(330e-9)
    assert t.total["fetch_frame"] == pytest.approx(70e-9)
    assert t.total["frame"] == pytest.approx(400e-9)  # apart from its parent only
    rec = {r[0]: r for r in t.records}
    assert rec["tracking"][2] - rec["tracking"][1] == 400
    assert rec["fetch_frame"][3] == "tracking"


def test_each_thread_keeps_its_own_stack():
    t = PhaseTimers()
    entered, release = threading.Barrier(2), threading.Event()

    def worker(name):
        with t.span(name):
            entered.wait()  # both spans are open at once
            release.wait(5)
            with t.span(name + ".child"):
                pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
        for th in threads:
            th.start()
        release.set()
        for th in threads:
            th.join()
    parents = {r[0]: r[3] for r in t.records}
    assert parents == {"a": None, "b": None, "a.child": "a", "b.child": "b"}
    threads_of = {r[0]: r[4] for r in t.records}
    assert threads_of["a"] == threads_of["a.child"] != threads_of["b"] == threads_of["b.child"]


def test_spans_close_on_an_exception():
    t = PhaseTimers()
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.sync("wait"):
                raise ValueError("inside")
    assert t.count["outer"] == 1 and t.count["sync.wait"] == 1 and t.tallies["syncs"] == 1
    assert t._stack() == []
    with t.span("after"):
        pass
    assert t.count["after"] == 1


def test_records_only_inside_a_profiler_window():
    t = PhaseTimers()
    with t.span("before"):
        pass
    snap = t.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with t.span("inside"):
            pass
    with t.span("after"):
        pass
    assert [r[0] for r in t.records] == ["inside"]
    delta = t.delta_summary(snap)
    assert delta["spans"]["clock"] == "unix_ns"
    assert [r[0] for r in delta["spans"]["records"]] == ["inside"]
    assert "spans" not in t.delta_summary(t.snapshot())
    assert t.count["before"] == t.count["after"] == 1  # totals are kept throughout


def test_spans_share_the_profilers_clock():
    """A `record_function` range opened inside a span lies within the span's
    [start_ns, end_ns] as the profiler stamps it."""
    t = PhaseTimers()
    x = torch.randn(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("outer"):
            with torch.profiler.record_function("inner_range"):
                (x @ x).sum()
    (_, start, end, _, _), = t.records
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range"]
    assert len(ev) == 1
    assert start <= ev[0].start_ns() and ev[0].start_ns() + ev[0].duration_ns() <= end


def test_module_level_spans_write_to_the_active_recorder():
    a, b = PhaseTimers(), PhaseTimers()
    before = profiling.active()
    try:
        profiling.activate(a)
        with profiling.span("x"), profiling.sync("y"):
            profiling.tally("z", 3)
        profiling.activate(b)

        @profiling.spanned("f")
        def f(v):
            return v + 1

        assert f(1) == 2
    finally:
        profiling.activate(before)
    assert a.count["x"] == 1 and a.tallies["syncs"] == 1 and a.tallies["z"] == 3
    assert b.count["f"] == 1 and "f" not in a.count


def _tiny_slam():
    from monogs_dev_tpu_torch.core.system import SLAM
    from monogs_dev_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs/synthetic/tiny_rgbd.yaml"))
    # the inline pump, as the benchmark's cell runs it
    cfg["Training"]["single_thread"] = False
    cfg["Dataset"]["single_thread"] = False
    cfg["Results"]["save_results"] = False
    return SLAM(cfg, "cpu", seed=0)


def _inside(rec, outer):
    return rec[4] == outer[4] and outer[1] <= rec[1] and rec[2] <= outer[2]


def test_a_tracked_frame_and_a_mapping_round_leave_the_span_tree():
    slam = _tiny_slam()
    slam.run(max_frames=2)
    snap = slam.timers.snapshot()
    handled = slam.backend_thread.handled["idle"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        slam.run(max_frames=4)  # frame 2 prefetches frame 3, frame 3 none
    assert slam.backend_thread.handled["idle"] == handled + 2  # an idle round a frame
    delta = slam.timers.delta_summary(snap)
    recs = delta["spans"]["records"]
    n_iters = delta["tracking_iters"]["count"]
    assert n_iters > 0
    names = [r[0] for r in recs]
    for name in ("frame", "pump", "round.idle", "map.iter", "map.backward", "map.adam",
                 "tracking", "track.rebin", "track.iter", "track.backward", "track.adam",
                 "track.final", "fetch_frame", "project", "bin", "render", "loss",
                 "sync.stop"):
        assert name in names, name
    assert names.count("track.iter") == n_iters == delta["track.iter"]["count"]
    assert names.count("sync.stop") == n_iters
    assert delta["syncs"]["count"] == sum(n.startswith("sync.") for n in names)
    for outer in (r for r in recs if r[0] in ("track.iter", "map.iter")):
        assert any(r[0] == "project" and r[3] == outer[0] and _inside(r, outer)
                   for r in recs), outer
    # tracking less the next frame's fetch inside it is the tracking timer
    tracking = [r for r in recs if r[0] == "tracking"]
    fetched = [r for r in recs if r[0] == "fetch_frame" and r[3] == "tracking"]
    assert len(tracking) == 2 and len(fetched) == 1
    want = (sum(r[2] - r[1] for r in tracking) - sum(r[2] - r[1] for r in fetched)) * 1e-9
    assert slam.timers.total["tracking"] - snap[0]["tracking"] == pytest.approx(want, abs=1e-6)
    assert delta["fetch_frame"]["count"] == 2  # frame 2 fetched in its frame, 3 prefetched
