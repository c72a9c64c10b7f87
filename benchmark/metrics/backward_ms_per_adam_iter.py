"""Frontend (`core/tracking.py`): the seconds of the port's `track.backward`
span (the tracking loss's `autograd.grad`, the blend's K2 and the caller's
wait for it) over the window's Adam iterations (`tracking_iters`), in ms."""

from ._spans import seconds, tally


def read(ctx):
    s, iters = seconds(ctx, lambda name: name == "track.backward"), tally(ctx, "tracking_iters")
    return None if s is None or not iters else 1e3 * s / iters
