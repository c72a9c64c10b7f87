"""Backend (`core/backend.py`, `core/mapping.py`): the host time of the
benchmark's span around `BackendEngine.map` inside the window, per window
frame, in ms."""


def read(ctx):
    frames = sum(s.get("frames", 0) for s in ctx["sessions"])
    if frames == 0 or any("trace" not in s for s in ctx["sessions"]):
        return None
    total = 0.0
    for s in ctx["sessions"]:
        t0, t1 = s["t0"], s["t_end"]
        total += sum(max(0.0, min(b, t1) - max(a, t0))
                     for n, a, b in s["trace"]["spans"] if n == "mapping")
    return 1e3 * total / frames
