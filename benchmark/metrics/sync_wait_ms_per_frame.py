"""Device (one H100): the seconds of every `sync.*` span of the port (each a
call at which the host waits for the card) over the window, per window
frame, in ms."""

from ._spans import is_sync, per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, is_sync)
