"""Share of its roofline that the orbit kernel `csrc/orbit_resolve.cu`
reaches in the traced scan: the bytes its passes need over the data
sheet's 3.35 TB/s, over the device time of its kernels.

Bytes, from the input size and the mission count only (`chip_smoke.py`'s
arithmetic): for every mission whose decoder keeps an event chain (the
double-byte CJK encodings and ISO-2022-JP), one int32 step read and one
byte of mask written a position: 5 bytes a byte of input. One pass over
64 MiB: 335,544,320 bytes.
"""

from portbench import trace

KERNEL = "orbit_kernel"
CHAIN = {"shift_jis", "euc-kr", "gb18030", "iso-2022-jp", "big5", "euc-jp",
         "gbk", "sjis", "csshiftjis"}


def pass_bytes(image_bytes: int) -> int:
    return 5 * image_bytes


def chain_missions(argv) -> int:
    return sum(1 for k, a in enumerate(argv[:-1])
               if a == "-e" and argv[k + 1].lower() in CHAIN)


def read(ctx):
    ev = ctx.events
    if not ev:
        return None
    t = trace.kernel_seconds(ev, KERNEL)
    n = chain_missions(ctx.config["argv"])
    if t <= 0 or n == 0:
        return None
    bound = n * pass_bytes(ctx.traced_bytes) / ctx.peak_bytes_per_s
    return 100.0 * bound / t
