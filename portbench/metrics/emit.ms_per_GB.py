"""Milliseconds a GB scanned in the C++ emitter of a buffered scan
(`native/`) under the port's scope `host.emit`."""


def read(ctx):
    return ctx.ms_per_gb("host.emit")
