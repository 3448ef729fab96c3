"""Percent of the feed's pieces whose bytes were a view of the buffer's
one shared upload to the card: 100 x the port's counter
`feed.shared_pieces` (bumped in `device_events._piece_bytes` where a
piece reads the upload `run._device_maps` made) / its counter
`feed.pieces` (every piece `device_events._piece_feed` clamped), read
from `stringsext_tpu_torch.utils.profiling` in this process; the
counters run from the port's import on, so the warm-up scan and the
profiled scan are in both. Below 100, pieces copied their own bytes to
the card (a buffer above one feed piece). Nothing to read where no piece
was fed or the port has no such counters."""


def read(ctx):
    from stringsext_tpu_torch.utils import profiling

    counts = getattr(profiling, "_counts", None) or {}
    pieces = counts.get("feed.pieces", 0)
    if pieces <= 0:
        return None
    return 100.0 * counts.get("feed.shared_pieces", 0) / pieces
