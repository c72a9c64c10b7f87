"""Entry (`core/system.py::SLAM.run`, one frame a call): the 90th
percentile of the host time of a window frame's call, pooled over the
sessions, in ms."""

import statistics


def read(ctx):
    times = [t for s in ctx["sessions"] for t in s.get("frame_s", [])]
    if len(times) < 2:
        return None
    return 1e3 * statistics.quantiles(times, n=10)[8]
