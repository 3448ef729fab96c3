"""Percent of the feed's pieces whose report clamp ran on the card's
kernel: 100 x the port's counter `feed.clamp.kernel` (pieces the kernel
`csrc/report_clamp.cu` clamped) / its counter `feed.pieces` (every piece
`device_events._piece_feed` clamped), read from
`stringsext_tpu_torch.utils.profiling` in this process; the counters run
from the port's import on, so the warm-up scan and the profiled scan are
in both. Nothing to read where the port has no such counters."""


def read(ctx):
    from stringsext_tpu_torch.utils import profiling

    counts = getattr(profiling, "_counts", None) or {}
    pieces = counts.get("feed.pieces", 0)
    if pieces <= 0:
        return None
    return 100.0 * counts.get("feed.clamp.kernel", 0) / pieces
