"""Milliseconds a GB scanned in the chain kinds' lanes (the double-byte
CJK decoders and ISO-2022-JP: `device_events._chain_piece_lanes`) under
the port's scope `feed.chain`, inside `feed.lanes`: the piece to the
card, the as-if-start lanes, the orbit, ISO-2022-JP's state transfer and
the next entry, waits included. Nothing to read where the mission set
has no chain kind or the port has no such scope."""


def read(ctx):
    return ctx.ms_per_gb("feed.chain")
