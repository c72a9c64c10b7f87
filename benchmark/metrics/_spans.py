"""Shared arithmetic of the readers of the port's spans and counters
(`utils/profiling.py::PhaseTimers`): `session.py` passes the recorder's
`delta_summary` over the window as `sessions[k]["timers"]`, each timer with
`total_s` and `self_s` and, from a traced window, the span records under
"spans" (`(name, start_ns, end_ns, parent, thread)` on the Unix epoch).
A reader returns None where a session lacks what it reads: a program
without these spans."""


def frames(ctx):
    return sum(s.get("frames", 0) for s in ctx["sessions"])


def seconds(ctx, match, key="total_s"):
    """The `key` seconds of the timers whose name `match` accepts, pooled
    over the sessions; None where a session has none of them."""
    total = 0.0
    for s in ctx["sessions"]:
        rows = [v[key] for k, v in (s.get("timers") or {}).items()
                if match(k) and isinstance(v, dict) and key in v]
        if not rows:
            return None
        total += sum(rows)
    return total


def tally(ctx, name):
    """A tally's count over the window, pooled over the sessions; None where
    a session has none."""
    rows = [(s.get("timers") or {}).get(name) for s in ctx["sessions"]]
    if any(r is None or "count" not in r for r in rows):
        return None
    return sum(r["count"] for r in rows)


def records(session):
    """The session's span records, or None without a traced window of
    spans."""
    spans = (session.get("timers") or {}).get("spans")
    return None if spans is None else spans["records"]


def per_frame_ms(ctx, match, key="total_s"):
    n, s = frames(ctx), seconds(ctx, match, key)
    return None if s is None or n == 0 else 1e3 * s / n


def is_sync(name):
    return name.startswith("sync.")
