"""Shared arithmetic of the kernels' roofline readers: the sampled launches'
least time (`yardstick.bound`) over their device time in the trace, pooled
over the sessions, in %."""


def share(ctx, kernel):
    bound = device = 0.0
    for s in ctx["sessions"]:
        d = (s.get("trace") or {}).get("device")
        r = None if d is None else d.get(kernel)
        if r is None:
            return None
        bound += r["bound_ms"]
        device += r["device_ms"]
    return 100.0 * bound / device if device > 0 else None
