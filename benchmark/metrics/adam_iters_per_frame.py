"""Frontend (`core/tracking.py`): the port's `tracking_iters` tally over
the window, per window frame."""

from ._timers import per_frame


def read(ctx):
    return per_frame(ctx, "tracking_iters", "count")
