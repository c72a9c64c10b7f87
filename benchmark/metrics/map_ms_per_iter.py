"""Backend (`core/backend.py`, `core/mapping.py`): the seconds of the port's
`round.*` spans (each a `BackendEngine.map` call, named by the round's
cause) over the window's mapping iterations (`BackendEngine.telemetry`'s
`map_iters`), in ms."""

from ._spans import seconds


def read(ctx):
    s = seconds(ctx, lambda name: name.startswith("round."))
    iters = sum(int((x.get("mapping") or {}).get("map_iters", 0)) for x in ctx["sessions"])
    return None if s is None or iters == 0 else 1e3 * s / iters
