"""Data (`data/datasets.py`, `data/image_io.py`, `data/jpeg.py`): the port's
`PhaseTimers` `fetch_frame` seconds over the window, per window frame, in
ms."""

from ._timers import per_frame


def read(ctx):
    v = per_frame(ctx, "fetch_frame", "total_s")
    return None if v is None else 1e3 * v
