"""Milliseconds a GB scanned in the streamed chunk loop's own work
(`run._run_streaming_stdin`) under the port's scope `scan`: the emitter
and the waits that the feed does not overlap."""


def read(ctx):
    if ctx.traffic.get("mode") != "streamed":
        return None
    return ctx.ms_per_gb("scan")
