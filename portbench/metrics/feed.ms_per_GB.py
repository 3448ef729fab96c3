"""Milliseconds a GB scanned in the run-table feed (`ops/device_events.py`,
`ops/classify*.py`) under the port's scope `device.feed`. In a streamed
scan the feed runs on the main thread while the reader thread loads the
next chunk."""


def read(ctx):
    return ctx.ms_per_gb("device.feed")
