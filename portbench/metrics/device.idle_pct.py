"""Percent of the traced scan in which card 0, which runs the feed, runs no
kernel, copy or set (the profiler's trace)."""

from portbench import trace


def read(ctx):
    ev = ctx.events
    if not ev or ev["span"] is None or not ctx.devices:
        return None
    window = trace.window_seconds(ev)
    if window <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ev, 0) / window)
