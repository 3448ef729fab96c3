"""Milliseconds a GB scanned in the merge and the output (`run.write_output`)
under the port's scope `merge+format`."""


def read(ctx):
    return ctx.ms_per_gb("merge+format")
