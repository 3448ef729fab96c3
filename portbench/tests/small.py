"""A cell's traffic mix cut to a size that a CPU test run can hold, and
the stateful mission set that the reference's CJK tests run."""

import copy


def small_traffic(traffic: dict, image_bytes: int = 2 << 20) -> dict:
    t = copy.deepcopy(traffic)
    t["image_bytes"] = image_bytes
    t["images"] = min(int(t["images"]), 2)
    t["warmup_bytes"] = min(int(t["warmup_bytes"]), image_bytes // 2)
    t["seam_every"] = image_bytes // 4
    if t["mode"] == "streamed":
        t["stream_file_min"] = image_bytes // 4
    return t


# The port's stateful kinds with the Asian block filter: three double-byte
# CJK decoders, ISO-2022-JP with its modes, and UTF-8. No cell runs it; it
# holds the reference's CJK decoders and the orbit's byte count to the port.
CJK_ARGV = ["-t", "x", "-u", "Asian", "-e", "Shift_JIS", "-e", "EUC-KR",
            "-e", "gb18030", "-e", "ISO-2022-JP", "-e", "UTF-8"]
