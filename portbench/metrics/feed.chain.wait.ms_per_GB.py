"""Milliseconds a GB scanned with the host blocked on the card in the
chain kinds' lanes, under the port's scope `feed.chain.wait`, inside
`feed.chain`: ISO-2022-JP's state transfer (`.tolist()`) and the chain's
next entry (`int(torch.max(...))` of the orbit, `int(step[last])`), the
syncs `_chain_piece_lanes` makes for every piece of every chain
mission."""


def read(ctx):
    return ctx.ms_per_gb("feed.chain.wait")
