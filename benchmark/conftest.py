"""pytest settings of the benchmark's own tests (`benchmark/tests/`): the
`gpu` marker, the `card` fixture that skips without a CUDA card, and
`tiny_cell`, a cell of BENCHMARK.json cut to a size the CPU runs in
seconds (the tests' size, never a benchmark cell)."""

import copy

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips itself on a machine without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def make_tiny_cell(workload: str, w: int = 96, h: int = 64, frames: int = 6) -> dict:
    """`workload` is a cell of BENCHMARK.json or "<config>:<traffic>", the
    names of files under benchmark/configs and benchmark/traffic."""
    from benchmark.run import load_cell, load_files

    cell = load_files(*workload.split(":")) if ":" in workload else load_cell(workload)
    cfg = copy.deepcopy(cell["config"])
    c = cfg["config"]
    cal = c["Dataset"]["Calibration"]
    s = w / cal["width"]
    cal.update(fx=cal["fx"] * s, fy=cal["fy"] * s, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    c["Training"].update(init_itr_num=30, tracking_itr_num=15, mapping_itr_num=8)
    cell["config"] = cfg
    cell["traffic"] = dict(cell["traffic"], sessions=1, frames=frames)
    return cell


@pytest.fixture
def tiny_cell():
    return make_tiny_cell
