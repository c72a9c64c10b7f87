"""Frontend (`core/frontend.py`, `core/tracking.py`): the port's
`PhaseTimers` `tracking` seconds over the window, per window frame, in ms."""

from ._timers import per_frame


def read(ctx):
    v = per_frame(ctx, "tracking", "total_s")
    return None if v is None else 1e3 * v
