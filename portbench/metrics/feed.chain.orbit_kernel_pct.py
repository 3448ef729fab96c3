"""Percent of the chain kinds' pieces whose orbit ran on the card's
kernel: 100 x the port's counter `feed.chain.orbit_kernel` (pieces whose
orbit `csrc/orbit_resolve.cu` resolved) / its counter `feed.chain.pieces`
(every piece through `device_events._chain_piece_lanes`), read from
`stringsext_tpu_torch.utils.profiling` in this process; the counters run
from the port's import on, so the warm-up scan and the profiled scan are
in both. 100 says `orbit_roofline`'s bytes are the kernel's. Nothing to
read where the port has no such counters."""


def read(ctx):
    from stringsext_tpu_torch.utils import profiling

    counts = getattr(profiling, "_counts", None) or {}
    pieces = counts.get("feed.chain.pieces", 0)
    if pieces <= 0:
        return None
    return 100.0 * counts.get("feed.chain.orbit_kernel", 0) / pieces
