"""One reader a per-layer metric, `<metric name>.py::read(ctx)`: ctx holds
`sessions` (each session's numbers, `session.py::run_session`), `start` and
`end` (the window on the host clock) and, traced, `device` (`breakdown.summary`'s
busy seconds, window seconds and breakdown). A reader returns the metric's value,
or None where it finds nothing to read; the metric is then left out."""
