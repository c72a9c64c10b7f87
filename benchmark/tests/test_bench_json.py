"""BENCHMARK.json against the benchmark's rules: keys, names, units and
their characters, each metric's layer, `moves` and `workloads`, and the
files that each entry names."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32 and all(1 <= len(w) <= 200 for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert {"ate_cm", "render_mae", "grad_rel", "map_grad_rel",
                "map_step_rel"} <= set(conf["limits"])
    assert len({c["file"] for c in bench["configs"]}) == len(names)


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert traffic["sessions"] >= 1 and traffic["frames"] > 2


def test_every_config_and_traffic_file_is_used_and_loads(bench):
    """No configuration or traffic file lies unused; each pair loads."""
    from benchmark.run import load_files

    configs = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "configs")))
    mixes = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "traffic")))
    assert configs == sorted(os.path.basename(c["file"])[:-5] for c in bench["configs"])
    assert mixes == sorted({w["traffic"] for w in bench["workloads"]})
    for c in configs:
        for t in mixes:
            cell = load_files(c, t)
            assert cell["config"]["layout"] in ("tum", "replica")
            assert {"rad_per_frame", "m_per_frame", "sessions", "frames"} <= set(cell["traffic"])


def test_metrics(bench):
    e2e, per_layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per_layer]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e} and _line(m["layer"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        got = [m["name"] for m in e2e if w in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2
        assert any(w in m.get("workloads", cells) for m in per_layer)
    layers = {}
    for m in per_layer:  # one name per layer, letter for letter
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_the_command_stays_under_paths(bench):
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    for w in bench["command"]:
        assert not w.startswith("/") and ".." not in w
