"""Device (one H100): 100 less the union of every device operation's
interval in the sessions' traces, as a share of the measured window."""


def read(ctx):
    busy_s, window_s, _ = ctx["device"]
    if busy_s is None or window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)
