"""Frontend (`core/frontend.py`, `core/tracking.py`): the port's `sync.*`
records that lie inside a `tracking` record of the same thread, over the
window's Adam iterations (`tracking_iters`): the host waits for the card
that one tracked frame makes, per iteration."""

import bisect

from ._spans import is_sync, records, tally


def inside_tracking(recs):
    """How many sync records lie inside a tracking record of their thread."""
    spans = {}
    for name, a, b, _, thread in recs:
        if name == "tracking":
            spans.setdefault(thread, []).append((a, b))
    for v in spans.values():
        v.sort()
    starts = {t: [a for a, _ in v] for t, v in spans.items()}
    n = 0
    for name, a, b, _, thread in recs:
        if not is_sync(name) or thread not in spans:
            continue
        i = bisect.bisect_right(starts[thread], a) - 1
        if i >= 0 and b <= spans[thread][i][1]:
            n += 1
    return n


def read(ctx):
    n = 0
    for s in ctx["sessions"]:
        recs = records(s)
        if recs is None:
            return None
        n += inside_tracking(recs)
    iters = tally(ctx, "tracking_iters")
    return n / iters if iters else None
