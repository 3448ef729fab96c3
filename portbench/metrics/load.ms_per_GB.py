"""Milliseconds a GB scanned in the buffered input load (`input.load_stream`
under the port's scope `input.load`)."""


def read(ctx):
    return ctx.ms_per_gb("input.load")
