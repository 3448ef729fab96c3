"""Milliseconds a GB scanned in the hot map (`run.device_hot_ranges_swar`,
`ops/swar.py`, `parallel/mesh.py` over several cards) under the port's
scope `device.hotmap`."""


def read(ctx):
    return ctx.ms_per_gb("device.hotmap")
