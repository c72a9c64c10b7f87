"""The fixture-eval tool's scale row (`monogs_dev_tpu_torch/tools/
run_fixture_evals.py scale`, configs/synthetic/scale_vga.yaml) on the CPU,
cut to a tiny size and short budgets: the row's keys and its gates. The
row's full depth runs on the card only (PERF.md)."""

import json
import os

import numpy as np
import torch

from monogs_dev_tpu_torch.utils.config import load_config

torch.set_num_threads(2)


SCALE_KEYS = ["ate_cm", "alive_end", "alive_max_at_keyframe", "map_grows", "map_compactions",
              "insert_dropped", "insert_evicted", "densify_dropped", "insert_requested",
              "densify_requested", "insert_dropped_share", "densify_dropped_share",
              "n_keyframes", "psnr_before", "ssim_before", "psnr_after", "ssim_after",
              "tracked_fps", "wall_s", "gates", "kernels"]


def _short_budgets(path):
    """Short budgets, and no keyframe before frame 6, so that frame 5, the
    one the eval renders in a 7-frame run, is not a keyframe
    (tests/test_torch_replay.py)."""
    cfg = load_config(path)
    cfg["Training"].update(init_itr_num=20, mapping_itr_num=5, tracking_itr_num=10,
                           kf_interval=6)
    return cfg


def test_scale_row_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The tool's scale row, cut to 7 frames at 64x48 with short budgets on
    the CPU: the row's keys after the card line and the wall seconds, its
    counts consistent with the telemetry, its gates read off its own
    numbers and the exit code from them; no kernel is timed on the CPU."""
    from monogs_dev_tpu_torch.tools import run_fixture_evals as rfe

    monkeypatch.setattr(rfe, "_base_config", _short_budgets)
    rc = rfe.main(["scale", "--frames", "7", "--size", "64x48", "--device", "cpu",
                   "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    (line,) = [ln for ln in lines if ln.startswith("SCALE ROW ")]
    at = lines.index(line)
    assert lines[at - 2] == "device: cpu" and lines[at - 1].startswith("scale wall seconds: ")
    row = json.loads(line[len("SCALE ROW "):])
    assert list(row) == SCALE_KEYS and row["kernels"] is None
    assert all(np.isfinite(v) for k, v in row.items() if k not in ("gates", "kernels")), row
    assert row["n_keyframes"] >= 1 and row["insert_requested"] > 0
    assert 0 < row["alive_max_at_keyframe"] <= 131072 and row["alive_end"] > 0
    assert row["insert_dropped_share"] == (
        (row["insert_dropped"] + row["insert_evicted"]) / row["insert_requested"])
    assert row["gates"] == {"map_grows": row["map_grows"] >= 1,
                            "drops": max(row["insert_dropped_share"],
                                         row["densify_dropped_share"]) < 0.1,
                            "ate": row["ate_cm"] < 3.0}
    assert rc == (0 if all(row["gates"].values()) else 1)
    assert os.path.exists(os.path.join(tmp_path, "scale_eval", "psnr", "after_opt"))
