"""Shared arithmetic of the readers of the port's `PhaseTimers`: a timer's
seconds or a tally's count over the window, per window frame, pooled over
the sessions."""


def per_frame(ctx, name, key):
    frames = sum(s.get("frames", 0) for s in ctx["sessions"])
    rows = [s.get("timers", {}).get(name) for s in ctx["sessions"]]
    if frames == 0 or any(r is None or key not in r for r in rows):
        return None
    return sum(r[key] for r in rows) / frames
