"""A run without the look for a card: one session of a cell cut to a tiny
size on the CPU, driven by `session.run_session` and summed up by
`run.result_of` as a run on the card is. A sound run comes out correct;
with the timed path broken underneath it does not, once for each fault
that the cells can have (one card: no exchange between cards to leave out),
and with mapping's result thrown away (`faults.map_unchanged`)."""

import math
import sys

import numpy as np
import pytest
import torch

from benchmark import faults, run
from benchmark.session import forbidden_modules, run_session

WORKLOAD = "tum_fr3_office.sessions4"


def _run(cell, tmp_path, trace=False, fault=None):
    # a window longer than the sequence: the session runs out of frames,
    # which ends the window, however slow this machine is
    out = run_session(cell, 0, seed=2 ** 31 + 3, seconds=600.0, trace=trace, device="cpu",
                      cache_root=str(tmp_path), fault=fault)
    assert out["ran_out"]
    return run.result_of(cell, [out], 1.0, 600.0, trace, "cpu")


def test_a_sound_run_is_correct_and_its_line_has_the_keys(tiny_cell, tmp_path):
    cell = tiny_cell(WORKLOAD)
    res = _run(cell, tmp_path)
    assert res["correct"], res["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"ate_cm", "render_mae", "grad_rel", "map_grad_rel",
                                  "map_step_rel"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(m["value"] > 0 and m["unit"] for m in res["metrics"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["info"]["mapping"][0]) == {"keyframes", "alive_start", "alive_end",
                                              "map_iters"}
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and "memory_peak_bytes" in dev


def test_a_traced_run_reads_the_host_side_layers(tiny_cell, tmp_path):
    res = _run(tiny_cell(WORKLOAD), tmp_path, trace=True)
    got = set(res["metrics"])
    assert {"frame_ms_p90", "tracking_ms_per_frame", "adam_iters_per_frame",
            "mapping_ms_per_frame", "fetch_ms_per_frame"} <= got
    # no device trace on the CPU: the device's metrics are left out, never 0
    assert not got & {"k1_roofline", "k2_roofline", "device_idle_pct"}
    assert "busy_s" not in res["device"]


def _unchanged(frontend_mod, tracking_mod, monkeypatch):
    real = frontend_mod.track_frame

    def track(params, active, T_init, *args):
        res = real(params, active, T_init, *args)
        return res._replace(T_w2c=torch.as_tensor(np.asarray(T_init), dtype=torch.float32))
    monkeypatch.setattr(frontend_mod, "track_frame", track)


def _half_batch(frontend_mod, tracking_mod, monkeypatch):
    real = tracking_mod.render_tiled

    def render(params, active, *args, **kwargs):
        half = active.clone()
        half[1::2] = False
        return real(params, half, *args, **kwargs)
    monkeypatch.setattr(tracking_mod, "render_tiled", render)


def _altered(frontend_mod, tracking_mod, monkeypatch):
    real = frontend_mod.track_frame

    def track(*args):
        res = real(*args)
        T = res.T_w2c.clone()
        T[0, 3] += 0.01  # a centimetre off where the pose is produced
        return res._replace(T_w2c=T)
    monkeypatch.setattr(frontend_mod, "track_frame", track)


def _gradient_altered(frontend_mod, tracking_mod, monkeypatch):
    real = tracking_mod.pose_gradient

    def grad(*args):
        loss, g = real(*args)
        return loss, 1.1 * g  # a tenth too large where the gradient is produced
    monkeypatch.setattr(tracking_mod, "pose_gradient", grad)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _gradient_altered],
                         ids=["state_unchanged", "half_the_batch", "pose_altered",
                              "gradient_altered"])
def test_a_broken_timed_path_is_not_correct(fault, tiny_cell, tmp_path, monkeypatch):
    from monogs_dev_tpu_torch.core import frontend as frontend_mod
    from monogs_dev_tpu_torch.core import tracking as tracking_mod

    fault(frontend_mod, tracking_mod, monkeypatch)
    res = _run(tiny_cell(WORKLOAD), tmp_path)
    assert not res["correct"], res["checks"]


def test_mapping_that_leaves_the_map_unchanged_is_not_correct(tiny_cell, tmp_path):
    res = _run(tiny_cell(WORKLOAD), tmp_path, fault=faults.map_unchanged)
    assert not res["correct"], res["checks"]
    assert res["checks"]["map_step_rel"]["value"] == pytest.approx(1.0)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "monogs_dev_tpu_torch_extra", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    monkeypatch.setitem(sys.modules, "monogs_dev_tpu.core", sys)
    assert forbidden_modules() == ["jaxlib", "monogs_dev_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOAD, "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_verdict_takes_the_worst_reading_of_every_session():
    s = [{"ate_sq": [0.0, 1e-6], "checks": {"render_mae": [1e-5], "grad_rel": [1e-4, 2e-4]}},
         {"ate_sq": [4e-6], "checks": {"render_mae": [3e-5, 2e-5], "grad_rel": [9e-3]}}]
    v = run.verdict(s, {"ate_cm": 3.0, "render_mae": 1e-4, "grad_rel": 1e-3,
                        "map_step_rel": 1e-2})
    assert v["render_mae"]["value"] == 3e-5 and v["grad_rel"]["value"] == 9e-3
    assert math.isclose(v["ate_cm"]["value"], 0.2)
    assert v["map_step_rel"]["value"] == math.inf  # a number never read fails


def test_the_window_counts_frames_that_ended_inside_it():
    a = {"t0": 100.0, "frame_end": [101.0, 104.0, 111.0], "ran_out": False}
    b = {"t0": 100.001, "frame_end": [102.0, 109.5, 112.0], "ran_out": False}
    assert run.window([a, b], 10.0) == (100.0, 110.0, 4)
    b_out = dict(b, frame_end=[102.0, 105.0], ran_out=True)  # ran out: the window ends there
    assert run.window([a, b_out], 10.0) == (100.0, 105.0, 4)


def test_the_union_of_device_intervals():
    from benchmark.trace import merge

    rng = np.random.default_rng(0)
    starts = rng.uniform(0.0, 100.0, 500)
    ends = starts + rng.exponential(0.3, 500)
    got = merge(starts, ends)
    want = []
    for s, e in sorted(zip(starts, ends)):  # the plain union
        if want and s <= want[-1][1]:
            want[-1][1] = max(want[-1][1], e)
        else:
            want.append([s, e])
    assert np.allclose(got, np.array(want))
    assert merge(np.zeros(0), np.zeros(0)).shape == (0, 2)


class _Event:
    def __init__(self, dev, name, start_s, dur_s):
        self.dev, self.nm, self.s, self.d = dev, name, start_s, dur_s

    def device_type(self):
        return self.dev

    def name(self):
        return self.nm

    def start_ns(self):
        return int(self.s * 1e9)

    def duration_ns(self):
        return int(self.d * 1e9)


def test_the_trace_reader_on_a_made_up_trace():
    """Kernel events by name, their union clipped to the window, and the
    blend kernels matched to their launches in order."""
    import types

    from benchmark.trace import Tracer

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    t0 = 1.7e9
    evs = [_Event(cuda, "blend_fwd_kernel_v2(float)", t0 + 1.0, 0.5),
           _Event(cpu, "cudaLaunchKernel", t0 + 0.9, 0.01),
           _Event(cuda, "reduce_kernel", t0 + 1.2, 0.5),
           _Event(cuda, "blend_bwd_kernel_v2(float)", t0 + 3.0, 0.25),
           _Event(cuda, "reduce_kernel", t0 + 9.5, 1.0)]
    tr = Tracer("cpu")
    tr.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    tr.wall0, tr.mono0 = t0, 0.0
    tr.n_fwd, tr.n_bwd = 1, 1
    out = tr.result(t0, t0 + 10.0)["device"]
    assert np.allclose(out["busy"], [[t0 + 1.0, t0 + 1.7], [t0 + 3.0, t0 + 3.25],
                                     [t0 + 9.5, t0 + 10.0]])
    assert out["by_name"]["reduce_kernel"] == pytest.approx(1.0)
    assert out["n_events"] == 4 and out["launches_matched"]
    assert out["K1"] == {"bound_ms": 0.0, "device_ms": 0.0, "n": 0}
