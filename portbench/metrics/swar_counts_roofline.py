"""Share of its roofline that `csrc/swar_counts.cu` reaches in the traced
scan: the bytes the counts pass needs over the data sheet's 3.35 TB/s,
over the device time of its kernels summed over the cards.

Bytes, from the input size and the mission count only (`chip_smoke.py`'s
arithmetic: each input byte read once, each count written once): the
image's bytes, plus int32 counts of `out_rows` rows for every 512-byte
block, `out_rows` the mission count's 2 rows a mission rounded up to 8
(ops/swar.py). The trio over 64 MiB: 67,108,864 + 8 x 131,072 x 4 =
71,303,168 bytes.
"""

from portbench import trace

KERNEL = "swar_counts_kernel"


def pass_bytes(image_bytes: int, missions: int) -> int:
    rows = ((2 * missions + 7) // 8) * 8
    return image_bytes + rows * 4 * (image_bytes // 512)


def read(ctx):
    ev = ctx.events
    if not ev:
        return None
    t = trace.kernel_seconds(ev, KERNEL)
    if t <= 0:
        return None
    missions = ctx.config["argv"].count("-e")
    bound = pass_bytes(ctx.traced_bytes, missions) / ctx.peak_bytes_per_s
    return 100.0 * bound / t
