"""The control: the plain reference computed at TF32 (the precision below
the float32-with-TF32-off that the port states, `core/system.py`) put in
the port's place in the render and gradient checks. Driven through a run
as `--control` drives it on the card (PERF.md gives those readings), the
run comes out not correct."""

from benchmark import run
from benchmark.session import run_session


def test_the_control_in_the_ports_place_is_not_correct(tiny_cell, tmp_path):
    cell = tiny_cell("tum_fr3_office.sessions4")
    out = run_session(cell, 0, seed=2 ** 31 + 5, seconds=600.0, trace=False, device="cpu",
                      cache_root=str(tmp_path), control=True)
    res = run.result_of(cell, [out], 1.0, 600.0, False, "cpu")
    checks = res["checks"]
    assert not res["correct"]
    assert checks["render_mae"]["value"] > checks["render_mae"]["limit"]
    assert checks["grad_rel"]["value"] > checks["grad_rel"]["limit"]
    # the program's own readings, kept beside, are within the limits
    own = out["program_checks"]
    assert max(own["render_mae"]) < checks["render_mae"]["limit"]
    assert max(own["grad_rel"]) < checks["grad_rel"]["limit"]
