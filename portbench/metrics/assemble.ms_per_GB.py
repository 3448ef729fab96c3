"""Milliseconds a GB scanned in the feed's host assembly
(`device_events._assemble_feed`) under the port's scope `host.assemble`,
which lies inside `device.feed`."""


def read(ctx):
    return ctx.ms_per_gb("host.assemble")
