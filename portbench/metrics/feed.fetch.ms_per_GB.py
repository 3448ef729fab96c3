"""Milliseconds a GB scanned with the host blocked on the card in the feed
(`device_events._piece_feed`: the `nonzero`s, the gathers and copies back
of `_fetch`, for the feedable chars and then the extras, and `int(last)`,
the report clamp's running max at the piece's end), under the port's
scope `feed.fetch`, inside `device.feed`. The host waits here for the
lanes, the accept mask and the report clamp kernel
(`csrc/report_clamp.cu`) that `feed.lanes` launched, and for the extras'
masks launched between the two fetches."""


def read(ctx):
    return ctx.ms_per_gb("feed.fetch")
