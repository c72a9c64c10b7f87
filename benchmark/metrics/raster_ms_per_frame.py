"""Raster ops (`ops/project.py`, `ops/rasterize.py`): the self time of the
port's `project` and `bin` spans (projection; binning and its compaction)
over the window, per window frame, in ms."""

from ._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, lambda name: name in ("project", "bin"), "self_s")
