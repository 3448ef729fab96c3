"""Percent of ISO-2022-JP's chain pieces whose last-set scans ran on the
card's kernel: 100 x the port's counter `iso.scan.kernel` (launches of
`csrc/last_set_scan.cu`, both transfer lanes of a piece in one, bumped in
`classify_iso2022._scan_last_sets`) / its counter `feed.chain.iso_pieces`
(the ISO-2022-JP pieces through `device_events._chain_piece_lanes`),
read from `stringsext_tpu_torch.utils.profiling` in this process; the
counters run from the port's import on, so the warm-up scan and the
profiled scan are in both. Nothing to read where no ISO-2022-JP piece
was fed or the port has no such counters."""


def read(ctx):
    from stringsext_tpu_torch.utils import profiling

    counts = getattr(profiling, "_counts", None) or {}
    pieces = counts.get("feed.chain.iso_pieces", 0)
    if pieces <= 0:
        return None
    return 100.0 * counts.get("iso.scan.kernel", 0) / pieces
