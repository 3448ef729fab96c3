"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once at real size and checks them, in eight
phases; any failure exits non-zero before the result line is printed:

1. card and build - the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, the nvcc build of `stringsext_tpu_torch/
   csrc/` and ptxas's report, the g++ build of the port's native emitter,
   and one device-to-device `copy_` of 335.5 MB with the bandwidth it
   reaches (a second yardstick beside the data sheet's 3.35 TB/s; the
   port calls it on no path);
2. kernel against plain version - `swar_counts` (CUDA) must equal
   `swar_counts_ref` run on the same card tensors bit for bit (tolerance
   0: integer counts) over several mission sets (the trio, grep,
   surrogate and astral UTF-16 filters, KOI8-R, a set without UTF-8, a
   NUL-accepting filter, 16 single-byte missions, every encoding at once
   with the plausible-byte specs of the stateful kinds) and corpora (64 MiB
   bench, a chunk of the streaming path, all byte pairs, all-0x00,
   all-0xFF, unaligned,
   1 / 7 / 8 / 9 / 131071 rows, and multi-byte chars and surrogate pairs
   across every 16-byte, 512-byte and 4096-byte seam and at both stream
   edges), in both hot_only modes, with and without xor_word; and a set
   of 160 missions, whose table needs more than the 48 KB of shared
   memory a kernel gets without asking; (2b) the event-chain orbit
   `_orbit_mask_blocked` (CUDA, `csrc/orbit_resolve.cu`) must equal its
   plain version bit for bit on random step fields with claim-rest tails
   at caps that are and are not multiples of 512, from starts 0, 3, 4, 7,
   515 and 600, on the step fields of the feed's 64 MiB pieces of the
   stateful corpus and of an 8 MiB piece from its middle (start 4), on
   steps of 1..8 and on blocks of steps 1..4 beside one block with a
   step of 300, at caps of 5 tiles of 16384 and 1000 and of 40 tiles,
   with starts in the last tile, n = 0 and n below the start, and on two
   launches back to back over different data; (2c) the card's run-table
   feed of Big5, EUC-JP, EUC-KR, GBK, gb18030, Shift_JIS and ISO-2022-JP
   over 64 MiB of `corpus.stateful_corpus` must equal the numpy oracle
   `_feed_from_host_events` array by array, extras included, and on a
   4 MiB cut the port's CPU feed and the card's feed in 256 KiB pieces;
3. the buffered main path - the port's CLI scan
   (`stringsext_tpu_torch.run.run`, device "cuda") of a 64 MiB bench
   corpus by name with UTF-8 + UTF-16LE +
   UTF-16BE must write the same bytes as the port's host path
   (`run.run_host`: the whole stream through the C++ emitter, no hot
   map); the kernel's launch counter is reset just before the port's run
   and must be positive after it;
4. goldens - every frozen golden case of tests/golden_extra (the CJK and
   ISO-2022-JP ones included) must come out byte for byte through the
   port on the card and through `run_host`, and (7d) the single-file
   cases once more with the file piped to stdin, the streaming path;
5. the run-table step (`stringsext_tpu_torch.entry`) - (a) the kernels
   `flagship_swar_lanes` and `flagship_mission_lanes` must equal their
   plain versions bit for bit (tolerance 0) on the 64 MiB bench corpus,
   all byte pairs, all-0x00, all-0xFF, the seam corpus and unpadded
   corpora of 32 rows, 64 rows, 1 MiB and 64 MiB whose edges read the
   lanes kernel's edge context; `flagship_swar_lanes` under five filter
   sets (the defaults, grep, UTF-16 intervals that reach the astral
   planes, one that covers the surrogates, 12 intervals a mission) and
   also on corpora of 1, 3 and 33 rows with a 4-byte UTF-8 char or a
   surrogate pair across every 16-byte and 512-byte seam, in UTF-8,
   UTF-16LE and UTF-16BE, whose edges tell zero bytes around the stream
   from any of its own; unaligned words must raise; (b) the step's four
   routes (swar,
   swar-lanes, lanes, plain) must give the same run tables on the 64 MiB
   bench corpus with and without xor_word, on a sparse 64 MiB corpus at a
   capacity above its run count, and (lanes and plain) for a mission set
   with more than 12 filter intervals; each route must launch exactly its
   kernels, counted from 0 just before it runs; (c) each route's step is
   timed with CUDA events, the swar route also at 128 MiB, with each
   route's peak device memory;
6. the per-mission lanes path - (a) the kernels `utf8_mission_lanes`,
   `utf16_mission_lanes` (LE and BE) and `single_byte_mission_lanes`
   (windows-1251, KOI8-R, macintosh) must equal their plain versions bit
   for bit (tolerance 0), with and without grep, on the corpora of phase
   5a, and the UTF-8 / UTF-16 fields must equal `flagship_mission_lanes`'
   bits 0-6 / 8-14 / 16-22 under the same params; (b) the pipeline's
   kernel route (`scan.mission_lanes` + `extract_runs_packed`) must give
   the run tables of its torch route (classification lanes +
   `extract_runs`) for six missions on two corpora with 128 zero bytes
   at each end, each kernel launched, counted from 0; (c) the CLI's lanes
   fallback: the port's scan of a 64 MiB bench corpus with missions
   `swar_counts` cannot take (UTF-8, UTF-16LE, UTF-16BE under a 64-
   interval AF filter), with the run-table feed on and off, must write
   `run_host`'s bytes without launching `swar_counts`; (d) the device
   profiler (`stringsext_tpu_torch.profile_device`) at 64 MiB: all six
   variants must report, and its kernel variants must launch their
   kernels;
7. the streaming path, at 64 MiB of the bench corpus with the trio -
   three rounds of the streamed scan (the file piped to stdin, 8 MiB
   chunks), the buffered scan and `run_host` in turns in this process, all
   byte-identical, with their wall times and peak device memory (the
   streamed peak must be below the buffered one); (a) the CLI as a child
   process (`python -m stringsext_tpu_torch --device cuda`): `cat file |`
   it, the file by name with `--stream-file-min` below its size, and from
   the pipe with the feed off, where `swar_counts` must launch once for
   every chunk (the child reports its launches under
   STRINGSEXT_PROFILE=1); (b) a stateful mission set (Shift_JIS, EUC-KR,
   gb18030, ISO-2022-JP, UTF-8 under `-u Asian`) over 64 MiB of a
   firmware-like corpus (`corpus.stateful_corpus`), streamed and
   buffered, feed on and feed off, in three turns with `run_host`: all
   byte-identical to `run_host`, the orbit kernel launched by every scan
   with the feed on, `swar_counts` by every scan with it off; and one
   streamed scan of 256 MiB of that corpus from a pipe, feed on, whose
   peak device memory must not pass the 64 MiB streamed scan's by more
   than two chunks (16 MiB); (c)
   `--checkpoint`: the child killed with SIGKILL after its third saved
   chunk and the same command run again must leave the uninterrupted
   scan's bytes and no checkpoint file;
8. inputs of 2 GiB or more - two files of 1.1 GiB each
   (`corpus.sparse_corpus`), `-e UTF-8`, scanned buffered on the card with
   the feed on (their stream is 2.2 GiB), must give `run_host`'s bytes.

Then every kernel and its plain version are timed at 64 MiB with CUDA
events: 20 repetitions, each a run of 10 launches (the minimum, median
and maximum of the per-launch time; a single launch between two events
also counts the wrapper's host work, and its median is printed beside).
Each kernel's bound is the bytes it must move (every input read once,
every output written once) over 3.35 TB/s, the data sheet's figure for an
H100 SXM; its operations are 32-bit integer logic, for which the data
sheet gives no peak, so no kernel's bound is by operations. The orbit's
bound counts its step field read once and its mask written once (5 bytes
a position), as its design moves them; it is also timed on the 8 MiB
piece of the streamed path.

The script imports torch, numpy and the port; it never imports jax or
the JAX package and asserts so. Its last two lines are a JSON object
describing the kernels and `{"ok": true, "device": {...}}`.
"""

import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
SIZE = 64 * MIB  # the resident corpus of the kernels and the step
CLI_SIZE = 64 * MIB  # the file the streamed CLI scans (phase 7)
BUFFERED_SIZE = 64 * MIB  # the files of the buffered CLI cells (3, 6c)
STATEFUL_SIZE = 64 * MIB  # the firmware-like corpus of phases 2c and 7b
STATEFUL_STREAM_SIZE = 256 * MIB  # its streamed scan from a pipe (7b)
TWO_FILE_SIZE = 1100 * MIB  # each of the two files of phase 8
STATEFUL_FEEDS = ["Big5", "EUC-JP", "EUC-KR", "GBK", "gb18030", "Shift_JIS",
                  "ISO-2022-JP"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# name -> (source under stringsext_tpu_torch/csrc, TPU kernel it replaces
# under stringsext_tpu/ops)
KERNELS = {
    "swar_counts": ("swar_counts.cu", "pallas_swar.py:820"),
    "flagship_swar_lanes": ("swar_lanes.cu", "pallas_swar.py:590"),
    "flagship_mission_lanes": ("mission_lanes.cu", "pallas_scan.py:291"),
    "utf8_mission_lanes": ("single_mission_lanes.cu", "pallas_scan.py:499"),
    "utf16_mission_lanes": ("single_mission_lanes.cu", "pallas_scan.py:367"),
    "single_byte_mission_lanes": ("single_mission_lanes.cu",
                                  "pallas_scan.py:387"),
    # code the JAX package leaves to XLA (no Pallas kernel)
    "orbit_resolve": ("orbit_resolve.cu",
                      "classify_cjk.py::_orbit_mask_blocked"),
}
# what each phase learns about a kernel: "err", "launches" {path: n},
# "ms" (min, median, max), "single_ms", "plain_ms", "bytes"
RESULTS = {name: {"err": 0, "launches": {}} for name in KERNELS}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, inner=10):
    """(min, median, max) milliseconds of one `fn()` on the current stream:
    `reps` CUDA-event readings, each over a run of `inner` calls, after
    three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _i in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    times.sort()
    return times[0], times[len(times) // 2], times[-1]


def time_kernel(name, label, kern, plain, nbytes):
    """Time `kern` and `plain` and keep the numbers under RESULTS[name];
    `nbytes` is what the kernel must move (inputs read once, outputs
    written once)."""
    ms = cuda_ms(kern)
    single = cuda_ms(kern, inner=1)[1]
    plain_ms = cuda_ms(plain, reps=20, inner=1)
    RESULTS[name].update(ms=ms, single_ms=single, plain_ms=plain_ms,
                         bytes=nbytes)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"{label}: kernel min/median/max {ms[0]:.4f} / {ms[1]:.4f} / "
        f"{ms[2]:.4f} ms a launch in runs of 10 (single launches: median "
        f"{single:.4f}); bound {bound:.4f} ms ({nbytes} bytes at 3.35 TB/s,"
        f" {100 * bound / ms[1]:.0f}% reached); plain torch min/median/max "
        f"{plain_ms[0]:.4f} / {plain_ms[1]:.4f} / {plain_ms[2]:.4f} ms")


def check_equal(name, what, got, want):
    """Hold a kernel's result to its plain version's; raises unless the
    max abs difference is 0."""
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    RESULTS[name]["err"] = max(RESULTS[name]["err"], err)
    if err or got.shape != want.shape:
        raise AssertionError(
            f"{name} != its plain version on {what}: first difference at "
            f"{(got != want).nonzero()[0].tolist()}")


def count_launches(path, fns):
    """Add the launch counts of `fns` {kernel name: wrapper} to the
    kernels' launches on `path`."""
    for name, fn in fns.items():
        by_path = RESULTS[name]["launches"]
        by_path[path] = by_path.get(path, 0) + fn.launches


def words_of(raw, device):
    """Stream bytes -> int32 [rows, 128] on `device`, zero-padded to whole
    512-byte blocks as the port's hot map pads a chunk."""
    import numpy as np

    pad = np.zeros((-len(raw)) % 512, np.uint8)
    buf = np.concatenate([np.asarray(raw, np.uint8), pad])
    return torch.from_numpy(buf.view(np.int32).reshape(-1, 128).copy()).to(
        device)


def sha_of(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(16 * MIB), b""):
            h.update(block)
    return os.path.getsize(path), h.hexdigest()


def seam_corpus():
    """96 rows of 512 bytes with a multi-byte char or a surrogate pair
    across every 16-byte boundary (so across every lane, row and 8-row
    seam of the kernels), in three 32-row parts: spaces with UTF-8 chars
    of 2, 3 and 4 bytes that start 1-3 bytes before the boundary, UTF-16LE
    text and UTF-16BE text with a pair's halves on the two sides of it.
    The stream starts with the low half of a pair and ends after a high
    half."""
    import numpy as np

    part = 32 * 512
    raw = np.full(3 * part, 0x20, np.uint8)
    chars = [np.frombuffer(c.encode(), np.uint8) for c in "é€𝄞"]
    for k, s in enumerate(range(16, part, 16)):
        c = chars[k % 3]
        o = s - 1 - (k // 3) % (len(c) - 1)
        raw[o:o + len(c)] = c
    for base, codec in ((part, "utf-16-le"), (2 * part, "utf-16-be")):
        raw[base:base + part] = np.tile(
            np.frombuffer("A".encode(codec), np.uint8), part // 2)
        pair = np.frombuffer("𝄞".encode(codec), np.uint8)
        for s in range(16, part + 16, 16):
            o = base + s - 2
            n = min(4, len(raw) - o)
            raw[o:o + n] = pair[:n]
    raw[0:2] = np.frombuffer("𝄞".encode("utf-16-le"), np.uint8)[2:]
    return raw


def edge_corpus(size, seed):
    """Unpadded random bytes whose edges read differently under the lanes
    kernel's edge context (stream bytes 4093-4095 before byte 0, row R-32
    after the last byte) than under zeros: continuation bytes at the
    start that a lead in byte 4095 claims, a UTF-16LE low surrogate in
    bytes 0-1 after a high one in bytes 4094-4095, and a UTF-8 lead in
    the last byte whose trail starts row R-32."""
    import numpy as np

    raw = np.random.default_rng(seed).integers(0, 256, size, np.uint8)
    raw[0:4] = (0x80, 0xDE, 0xBF, 0xDC)
    raw[4093:4096] = (0x41, 0x3D, 0xD8)
    raw[-1] = 0xC3
    raw[size - 4096] = 0xA9
    return raw


def phase_build(dev):
    from stringsext_tpu_torch import _build, native

    say(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    say(f"nvcc build: {nvcc_s:.2f} s ({time.perf_counter() - t0:.2f} s with "
        f"hashing) -> {os.path.relpath(path, REPO)}")
    log = path[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say("  ptxas:", line.strip())
    _build.load_library()
    # The C++ emitter builds with g++ at first use; build it here so that
    # no main-path wall time below includes it.
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the native emitter did not build")
    say(f"native emitter ready: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(native._LIB, REPO)}")
    n = 335_544_320  # what a lanes kernel moves at 64 MiB: 64 in, 256 out
    src = torch.empty(n, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    say(f"device-to-device copy_ of {n} bytes on {card_line()}: min/median/"
        f"max {ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms, "
        f"{2 * n / (ms[1] * 1e-3) / 1e12:.3f} TB/s of read plus write")


def phase_kernel(dev):
    import numpy as np

    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.encodings import ALL_ENCODING_NAMES
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops.specs import cjk_hot_spec, swar_mission_spec
    from stringsext_tpu_torch.ops.swar import swar_counts, swar_counts_ref
    from stringsext_tpu_torch.run import STREAM_CHUNK

    def specs(**kw):
        out = tuple(swar_mission_spec(m) for m in Missions.new(**kw).v)
        assert all(sp is not None for sp in out), kw
        return out

    trio = specs(flag_encoding=["UTF-8", "UTF-16LE", "UTF-16BE"])
    names = ["ascii"] + list(ALL_ENCODING_NAMES)
    # every encoding at once, as the scan asks: the exact spec, else the
    # plausible-byte spec of the stateful kinds and of macintosh
    group = tuple(swar_mission_spec(m) or cjk_hot_spec(m)
                  for m in Missions.new(flag_encoding=names).v)
    assert len(group) == len(names) > 40 and None not in group
    sbyte16 = tuple(sp for sp in group if sp[0] == "sbyte")[:16]
    assert len(sbyte16) == 16 and max(len(sp[1]) for sp in sbyte16) > 8
    spec_sets = {  # name: (specs, hot_only only)
        "trio": (trio, False),
        "grep": (specs(flag_encoding=["UTF-8", "UTF-16LE"],
                       flag_grep_char="63"), False),
        "utf16-surrogate": (specs(flag_encoding=["UTF-16LE"],
                                  flag_unicode_block_filter="Asian"), False),
        "utf16-astral": (specs(flag_encoding=["UTF-16BE"],
                               flag_unicode_block_filter="Uncommon"), False),
        "koi8r-sbyte": (specs(flag_encoding=["KOI8-R"],
                              flag_grep_char="63"), False),
        "no-utf8": (specs(flag_encoding=["UTF-16LE", "UTF-16BE", "KOI8-R"]),
                    False),
        "nul-accepting": (specs(flag_encoding=["UTF-8", "UTF-16LE", "KOI8-R"],
                                flag_ascii_filter="0x" + "f" * 32), False),
        "sbyte-16": (sbyte16, True),  # beyond the 8-bit budget of full mode
        f"hot-group-{len(group)}": (group, True),
    }
    pairs = np.array([[i, j] for i in range(256) for j in range(256)],
                     np.uint8).reshape(-1)
    big = make_corpus(SIZE, seed=0)
    odd_rows = SIZE // 512 - 1  # 131071 at 64 MiB
    seams = seam_corpus()
    corpora = {
        f"bench-{SIZE // MIB}MiB": big,
        "byte-pairs": pairs,
        "all-0x00": np.zeros(MIB, np.uint8),
        "all-0xFF": np.full(MIB, 0xFF, np.uint8),
        "unaligned-1MiB+777": make_corpus(MIB + 777, seed=1),
        "seams-96-rows": seams,
        f"{odd_rows}-rows": big[:odd_rows * 512],
        # a full chunk of the streaming path: 8 MiB and the 4096-byte pad
        "stream-chunk": np.concatenate(
            [big[:STREAM_CHUNK + 8], np.zeros(4088, np.uint8)]),
    }
    for rows in (1, 7, 8, 9):  # across the UTF-8 and UTF-16LE parts' seam
        corpora[f"{rows}-rows"] = seams[32 * 512 - 2048 - 3:][:rows * 512]
    ncmp = 0
    for cname, raw in corpora.items():
        w = words_of(raw, dev)
        for sname, (sp, hot_only_only) in spec_sets.items():
            for hot in ((True,) if hot_only_only else (False, True)):
                for xw in (None, 0x01010101, 0x80C2E020):
                    got = swar_counts(w, sp, hot_only=hot, xor_word=xw)
                    check_equal("swar_counts",
                                f"{cname} / {sname} hot_only={hot} xor={xw}",
                                got, swar_counts_ref(w, sp, hot_only=hot,
                                                     xor_word=xw))
                    ncmp += 1
        say(f"  {cname}: kernel == plain on every spec set/mode")
    # 160 records are 56 KB of dynamic shared memory, above the 48 KB a
    # kernel gets without asking: the launcher raises the limit itself
    wide = sbyte16 * 10
    for cname in ("seams-96-rows", "unaligned-1MiB+777"):
        w = words_of(corpora[cname], dev)
        check_equal("swar_counts", f"{cname} / {len(wide)} specs",
                    swar_counts(w, wide, hot_only=True),
                    swar_counts_ref(w, wide, hot_only=True))
        ncmp += 1
    say(f"  {len(wide)} specs ({len(wide) * 88 * 4} bytes of shared memory): "
        f"kernel == plain")
    say(f"phase 2: {ncmp} comparisons, max abs difference "
        f"{RESULTS['swar_counts']['err']} (tolerance 0)")
    return big, trio, {"sbyte-16": sbyte16, f"hot-group-{len(group)}": group}


def feed_missions():
    """{encoding: port mission} of the card's feed checks (phase 2c), under
    the stateful set's `-u Asian`."""
    from stringsext_tpu_torch.mission import Missions

    return {e: Missions.new(flag_encoding=[e],
                            flag_unicode_block_filter="Asian").v[0]
            for e in STATEFUL_FEEDS}


def piece_steps(raw, dev):
    """The step fields the feed's first 64 MiB piece hands the orbit for
    each stateful kind over `raw` (its read window, 8 bytes past the
    piece: `device_events.RIGHT_HALO`), with (n, start) as the feed gives
    them."""
    from stringsext_tpu_torch.encodings import encoding_kind
    from stringsext_tpu_torch.ops import device_events as de
    from stringsext_tpu_torch.ops.classify_cjk import cjk_pre_lanes
    from stringsext_tpu_torch.ops.classify_iso2022 import iso_pre_lanes

    piece = 64 * MIB
    b = torch.from_numpy(raw[:piece + de.RIGHT_HALO]).to(dev)
    out = {}
    for enc in ("Shift_JIS", "gb18030", "ISO-2022-JP"):
        kind = encoding_kind(enc)
        if kind == "iso-2022-jp":
            step = iso_pre_lanes(b, b.numel())[1]
        else:
            step = cjk_pre_lanes(b, kind, b.numel())[1]
        out[enc] = (step, piece, 0)
    return out


def chunk_steps(raw, dev):
    """The Shift_JIS step field of an 8 MiB piece (the streamed path's
    chunk) from the middle of `raw`, as the feed reads a piece: LEFT_CTX
    bytes before it and RIGHT_HALO after, n = its owned end and the start
    s0 = LEFT_CTX. Returns (step, n, start)."""
    from stringsext_tpu_torch.ops import device_events as de
    from stringsext_tpu_torch.ops.classify_cjk import cjk_pre_lanes

    lo = 8 * MIB - de.LEFT_CTX
    b = torch.from_numpy(raw[lo:16 * MIB + de.RIGHT_HALO]).to(dev)
    step = cjk_pre_lanes(b, "shift_jis", b.numel())[1]
    return step, 8 * MIB + de.LEFT_CTX, de.LEFT_CTX


def phase_orbit(dev, stateful):
    """Phase 2b: the orbit kernel against its plain version."""
    import numpy as np

    from stringsext_tpu_torch.ops.classify_cjk import (
        _orbit_mask_blocked,
        _orbit_mask_blocked_ref,
    )

    rng = np.random.default_rng(41)
    ncmp = 0
    for cap in (2048, 4096, 5000, 12288, 70001, MIB + 7, 64 * MIB + 12):
        step = rng.integers(1, 5, cap).astype(np.int32)
        for n in (cap, cap - 5, cap // 2 + 3):
            for i in range(max(n - 3, 0), n):  # claim-rest steps at the end
                step[i] = max(n - i, 1)
            st = torch.from_numpy(step).to(dev)
            for start in (0, 3, 4, 7, 515, 600):
                check_equal("orbit_resolve", f"cap {cap} n {n} start {start}",
                            _orbit_mask_blocked(st, n, start),
                            _orbit_mask_blocked_ref(st, n, start))
                ncmp += 1
                if cap > 64 * MIB and start > 4:
                    break  # the plain version takes ~70 ms here
    steps = piece_steps(stateful, dev)
    steps["Shift_JIS, 8 MiB"] = chunk_steps(stateful, dev)
    for enc, (step, n, start) in steps.items():
        got = _orbit_mask_blocked(step, n, start)
        check_equal("orbit_resolve", f"{enc} piece", got,
                    _orbit_mask_blocked_ref(step, n, start))
        ncmp += 1
        say(f"  {enc} piece of {step.numel()} bytes: kernel == plain, "
            f"{int(got.sum())} event starts")
    # the design's own edges: tiles of 16384 positions, blocks with a
    # live step above 4 (the general path), the start's constant map
    tile = 16384
    for cap in (5 * tile + 1000, 40 * tile):
        wide = rng.integers(1, 9, cap).astype(np.int32)  # steps 1..8
        one = rng.integers(1, 5, cap).astype(np.int32)
        one[7 * 512 + 100] = 300  # one block of steps 1..4 and one of 300
        for what, step, n in (("steps 1..8", wide, cap),
                              ("steps 1..8", wide, cap // 2 + 3),
                              ("one step of 300", one, cap),
                              ("n = 0", one, 0)):
            st = torch.from_numpy(step).to(dev)
            for start in (0, 3, 515, cap - 100, cap // 2 + 50):
                check_equal("orbit_resolve",
                            f"cap {cap} {what} n {n} start {start}",
                            _orbit_mask_blocked(st, n, start),
                            _orbit_mask_blocked_ref(st, n, start))
                ncmp += 1
    # two launches back to back on different data of one size, each held
    # to its plain version after both ran: a status word of the first
    # left in the second's look-back would show
    pair = [torch.from_numpy(rng.integers(1, 5, 8 * MIB).astype(np.int32)
                             ).to(dev) for _ in range(2)]
    got = [_orbit_mask_blocked(st, 8 * MIB, 1) for st in pair]
    for k, st in enumerate(pair):
        check_equal("orbit_resolve", f"back-to-back launch {k}", got[k],
                    _orbit_mask_blocked_ref(st, 8 * MIB, 1))
        ncmp += 1
    say(f"phase 2b: {ncmp} orbit comparisons, max abs difference "
        f"{RESULTS['orbit_resolve']['err']} (tolerance 0)")


def same_feed(what, got, want):
    """Hold a feed (nested tuples of numpy arrays, None for none) to
    another, array by array with dtypes."""
    import numpy as np

    if want is None or got is None:
        if not (want is None and got is None):
            raise AssertionError(f"{what}: one feed is None")
        return
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} != {len(want)} parts")
        for k, (g, w) in enumerate(zip(got, want)):
            same_feed(f"{what}[{k}]", g, w)
        return
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what}: arrays differ ({got.dtype} "
                             f"{got.shape}, {want.dtype} {want.shape})")


def feed_oracle(enc, size):
    """The numpy oracle's feed of `enc` over stateful_corpus(size) and its
    seconds; run in a worker process, which makes the corpus from its
    seed again."""
    from stringsext_tpu_torch.corpus import stateful_corpus
    from stringsext_tpu_torch.encodings import encoding_kind
    from stringsext_tpu_torch.ops import device_events as de

    raw = stateful_corpus(size, seed=0)
    m = feed_missions()[enc]
    t0 = time.perf_counter()
    want = de._feed_from_host_events(raw, m, encoding_kind(m.encoding_name),
                                     True)
    return want, time.perf_counter() - t0


def start_oracles(stateful):
    """A pool of worker processes, one an encoding of phase 2c, and the
    futures of their numpy oracles (they hold the interpreter lock, so
    threads would run them in turn). `main` starts them before phase 2:
    Big5's takes about three minutes (the host generator sorts every
    event in Python when the stream holds a multi-codepoint pair)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=len(STATEFUL_FEEDS),
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {e: pool.submit(feed_oracle, e, len(stateful))
                  for e in STATEFUL_FEEDS}


def phase_feeds(dev, stateful, oracles):
    """Phase 2c: the card's feeds of the stateful kinds against the numpy
    oracles that `start_oracles` runs in worker processes."""
    from stringsext_tpu_torch.ops import device_events as de

    cut = stateful[:4 * MIB + 13]
    missions = feed_missions()
    t0 = time.perf_counter()
    for enc, m in missions.items():
        t1 = time.perf_counter()
        got = de.runtable_feed(stateful, m, dev, with_extras=True)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        small = de.runtable_feed(cut, m, dev, with_extras=True)
        same_feed(f"{enc}: card vs CPU feed, 4 MiB cut", small,
                  de.runtable_feed(cut, m, torch.device("cpu"),
                                   with_extras=True))
        same_feed(f"{enc}: card feed in 256 KiB pieces, 4 MiB cut",
                  de.runtable_feed(cut, m, dev, with_extras=True,
                                   chunk=256 * 1024 + 2), small)
        want, t_host = oracles[enc].result()
        same_feed(f"{enc}: card feed vs numpy oracle", got, want)
        say(f"  {enc}: {len(got[0][0])} runs, {len(got[1][0])} extras; "
            f"card feed {t_card:.3f} s, numpy oracle {t_host:.3f} s (a "
            f"process of its own)")
    say(f"phase 2c: the card's feeds of {', '.join(STATEFUL_FEEDS)} equal the "
        f"numpy oracle at {len(stateful) // MIB} MiB, the CPU feed and the "
        f"256 KiB pieces ({time.perf_counter() - t0:.1f} s)")


def time_swar_counts(dev, big, trio, other_sets):
    """`swar_counts` at SIZE: the trio in both modes (hot_only is the
    CLI's and the kernels line's), and two larger sets."""
    from stringsext_tpu_torch.ops.swar import (
        out_rows,
        swar_counts,
        swar_counts_ref,
    )

    w = words_of(big, dev)

    def nbytes(sp):
        return len(big) + out_rows(len(sp)) * w.shape[0] * 4

    ms = cuda_ms(lambda: swar_counts(w, trio, hot_only=False))
    what = f"{SIZE // MIB} MiB"
    say(f"swar_counts trio {what} with run bounds: min/median/max "
        f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms")
    from stringsext_tpu_torch.run import STREAM_CHUNK

    chunk = w[:(STREAM_CHUNK + 4096) // 512]
    for sname, sp in (("trio", trio), *other_sets.items()):
        ms = cuda_ms(lambda: swar_counts(chunk, sp, hot_only=True))
        say(f"swar_counts {sname}, one chunk of the streaming path "
            f"({chunk.shape[0] * 512} bytes), hot_only: min/median/max "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms")
    for sname, sp in other_sets.items():
        ms = cuda_ms(lambda: swar_counts(w, sp, hot_only=True))
        say(f"swar_counts {sname} {what} hot_only: min/median/max "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms (bound "
            f"{nbytes(sp) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    time_kernel("swar_counts", f"swar_counts trio {what} hot_only",
                lambda: swar_counts(w, trio, hot_only=True),
                lambda: swar_counts_ref(w, trio, hot_only=True),
                nbytes(trio))


class stdin_from:
    """`sys.stdin` reading the file `path` through a pipe that a thread
    fills, as `cat path |` would, for a scan in this process."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        import threading

        r, w = os.pipe()

        def fill():
            try:
                with open(self.path, "rb") as f, os.fdopen(w, "wb") as sink:
                    shutil.copyfileobj(f, sink, MIB)
            except BrokenPipeError:
                pass  # the reader gave up; its own error is the one to see

        self.saved = sys.stdin
        sys.stdin = io.TextIOWrapper(os.fdopen(r, "rb"))
        self.thread = threading.Thread(target=fill, daemon=True)
        self.thread.start()

    def __exit__(self, *_exc):
        sys.stdin.close()
        sys.stdin = self.saved
        self.thread.join(60)


def cli_scan(label, argv, dst, dev=None, stdin_path=None, stats=None):
    """One scan into the file `dst`: the port on `dev`, or `run_host`
    when `dev` is None; with `stdin_path` that file is piped to stdin.
    Returns (size, sha256) and appends (wall s, peak device bytes) to
    `stats`."""
    import contextlib

    from stringsext_tpu_torch.cli import parse_args
    from stringsext_tpu_torch.run import run, run_host

    piped = stdin_from(stdin_path) if stdin_path else contextlib.nullcontext()
    with open(dst, "wb") as out, piped:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if dev is None:
            rc = run_host(parse_args(argv), out=out)
        else:
            rc = run(parse_args(argv), out=out, device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    size, sha = sha_of(dst)
    peak = torch.cuda.max_memory_allocated()
    if stats is not None:
        stats.append((wall, peak))
    mem = "" if dev is None else (f", peak device memory {peak} bytes "
                                  f"({peak / 2**30:.2f} GiB)")
    say(f"{label}: {size} bytes sha256 {sha[:16]} wall {wall:.3f} s{mem}")
    return size, sha


def phase_main_path(dev, tmp):
    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.ops import swar

    src = os.path.join(tmp, "buffered.bin")
    make_corpus(BUFFERED_SIZE, seed=0).tofile(src)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE", src]
    what = f"main path, {BUFFERED_SIZE // MIB} MiB trio"
    swar.swar_counts.launches = 0
    port = cli_scan(f"{what}, port on the card", argv,
                    os.path.join(tmp, "port.out"), dev)
    count_launches(f"cli flagship scan, {BUFFERED_SIZE // MIB} MiB",
                   {"swar_counts": swar.swar_counts})
    launches = swar.swar_counts.launches
    host = cli_scan(f"{what}, port host path (whole stream, no hot map)",
                    argv, os.path.join(tmp, "host.out"))
    if port != host:
        raise AssertionError(f"port output differs from run_host's: "
                             f"{port} != {host}")
    if launches <= 0:
        raise AssertionError("the main path never launched swar_counts")
    say(f"phase 3: outputs byte-identical; swar_counts launches {launches}")


def phase_goldens(dev, tmp):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from golden_extra import CASES, corpus_files, corpus_main

    from stringsext_tpu_torch.cli import parse_args
    from stringsext_tpu_torch.run import run, run_host

    single = os.path.join(tmp, "main.bin")
    with open(single, "wb") as f:
        f.write(corpus_main())
    multi = []
    for i, b in enumerate(corpus_files()):
        multi.append(os.path.join(tmp, f"f{i}.bin"))
        with open(multi[-1], "wb") as f:
            f.write(b)
    ncases = nstdin = 0
    for name, argv, is_multi in CASES:
        flags = argv
        argv = argv + (multi if is_multi else [single])
        with open(os.path.join(REPO, "tests", "golden_extra",
                               f"{name}.bin"), "rb") as f:
            want = f.read()
        for label, scan in (("the card", functools.partial(run, device=dev)),
                            ("run_host", run_host)):
            buf = io.BytesIO()
            assert scan(parse_args(argv), out=buf) == 0, name
            if buf.getvalue() != want:
                raise AssertionError(f"golden case {name} differs on {label}")
        ncases += 1
        if not is_multi:  # and through stdin, the streaming path
            buf = io.BytesIO()
            with stdin_from(single):
                assert run(parse_args(flags), out=buf, device=dev) == 0, name
            if buf.getvalue() != want:
                raise AssertionError(f"golden case {name} differs from stdin")
            nstdin += 1
    if ncases != len(CASES) or ncases < 15 or nstdin < 10:
        raise AssertionError(f"{ncases} golden cases ran, {nstdin} from stdin")
    say(f"phase 4 (and 7d): all {ncases} golden cases byte-identical on the "
        f"card and through run_host, the {nstdin} single-file ones also "
        f"streamed from stdin")


def cli_child(label, argv, dst, stdin_path=None, env=None):
    """`python -m stringsext_tpu_torch --device cuda ARGV -p DST` as a
    process of its own, with `cat STDIN_PATH |` before it when given, under
    STRINGSEXT_PROFILE=1. Returns ((size, sha256), the kernel launches and
    the peak device bytes it reports, its `device.hotmap` scope count)."""
    import re

    cmd = [sys.executable, "-m", "stringsext_tpu_torch", "--device", "cuda",
           *argv, "-p", dst]
    child_env = dict(os.environ, STRINGSEXT_PROFILE="1", **(env or {}))
    t0 = time.perf_counter()
    cat = None
    if stdin_path:
        cat = subprocess.Popen(["cat", stdin_path], stdout=subprocess.PIPE)
    try:
        r = subprocess.run(cmd, stdin=cat.stdout if cat else subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True, cwd=REPO,
                           env=child_env, timeout=600)
    finally:
        if cat:
            cat.stdout.close()
            cat.kill()
            cat.wait()
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{label}: exit code {r.returncode}\n"
                             f"{r.stderr[-2000:]}")
    launches = int(re.search(r"swar_counts launches (\d+)", r.stderr).group(1))
    peak = int(re.search(r"peak device memory (\d+) bytes", r.stderr).group(1))
    hot = re.search(r"^device\.hotmap\s+\S+\s+x(\d+)", r.stderr, re.M)
    out = sha_of(dst)
    say(f"{label}: {out[0]} bytes sha256 {out[1][:16]} wall {wall:.3f} s "
        f"(process start and imports included), swar_counts launches "
        f"{launches}, peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    return out, launches, peak, int(hot.group(1)) if hot else 0, r.stderr


def phase_streaming(dev, tmp):
    """Phase 7 (7d runs with phase 4)."""
    import signal

    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.ops import swar
    from stringsext_tpu_torch.run import STREAM_CHUNK

    src = os.path.join(tmp, "stream.bin")
    make_corpus(CLI_SIZE, seed=0).tofile(src)
    trio = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"]
    what = f"{CLI_SIZE // MIB} MiB trio"
    dst = os.path.join(tmp, "stream.out")
    nchunks = -(-CLI_SIZE // STREAM_CHUNK)

    # the yardstick, and the three routes in turns, in this process
    walls = {"streamed": [], "buffered": [], "run_host": []}
    outs = set()
    launches = {}
    for k in range(3):
        for route in walls:
            swar.swar_counts.launches = 0
            outs.add(cli_scan(
                f"7 round {k + 1}, {what}, {route}",
                trio + ([] if route == "streamed" else [src]), dst,
                None if route == "run_host" else dev,
                stdin_path=src if route == "streamed" else None,
                stats=walls[route]))
            launches[route] = swar.swar_counts.launches
    if len(outs) != 1:
        raise AssertionError(f"streamed, buffered and run_host differ: {outs}")
    want = outs.pop()

    # 7a: the CLI as a process: from a pipe, by name, and with the feed off
    piped, n_on, peak_on, _h, err_on = cli_child(
        f"7a {what}, cat | CLI, feed on", trio, dst, stdin_path=src)
    named, _n, _p, _h, _e = cli_child(
        f"7a {what}, CLI by name, --stream-file-min {MIB}",
        trio + ["--stream-file-min", str(MIB), src], dst)
    off, n_off, peak_off, hot_calls, err = cli_child(
        f"7a {what}, cat | CLI, feed off", trio, dst, stdin_path=src,
        env={"STRINGSEXT_RUNTABLE_FEED": "0"})
    if not piped == named == off == want:
        raise AssertionError(f"7a: {piped} {named} {off} != {want}")
    # one launch for every chunk that holds bytes: the whole chunks and,
    # when they left a tail over, the last one
    if n_off != hot_calls or n_off not in (nchunks, nchunks + 1):
        raise AssertionError(f"7a feed off: {n_off} launches, {hot_calls} hot "
                             f"maps, {nchunks} chunks")
    RESULTS["swar_counts"]["launches"][
        f"cli streamed from stdin, feed off, {CLI_SIZE // MIB} MiB "
        f"(child process)"] = n_off
    say("  profile of the streamed scan, feed off:\n    "
        + "\n    ".join(err.strip().splitlines()))
    say("  profile of the streamed scan, feed on:\n    "
        + "\n    ".join(err_on.strip().splitlines()))
    say(f"phase 7a: stdin, by name and feed off byte-identical to run_host; "
        f"feed off launched swar_counts {n_off} times for {nchunks} chunks of "
        f"{STREAM_CHUNK} bytes, feed on {n_on} times")

    # 7c: SIGKILL after some chunks, then the same command again
    ck = os.path.join(tmp, "scan.ck")
    cmd = [sys.executable, "-m", "stringsext_tpu_torch", "--device", "cuda",
           *trio, "--checkpoint", ck, "-p", dst, src]
    if os.path.exists(dst):
        os.unlink(dst)
    child = subprocess.Popen(cmd, cwd=REPO)
    try:
        deadline = time.time() + 300
        pos = 0
        while pos < 3 * STREAM_CHUNK:  # until three chunks are saved
            if child.poll() is not None or time.time() > deadline:
                raise AssertionError("7c: the scan ended or hung before its "
                                     "third checkpoint")
            time.sleep(0.05)
            if os.path.exists(ck):
                with open(ck) as f:
                    pos = json.load(f)["stream_pos"]
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
    with open(ck) as f:
        pos = json.load(f)["stream_pos"]
    cut = os.path.getsize(dst)
    if not (0 < pos < CLI_SIZE and 3 < cut < want[0]):
        raise AssertionError(f"7c: killed at {pos} of {CLI_SIZE}, {cut} bytes")
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=REPO, timeout=600).returncode
    if rc != 0 or sha_of(dst) != want or os.path.exists(ck):
        raise AssertionError(f"7c: resume rc {rc}, {sha_of(dst)} != {want}, "
                             f"checkpoint left: {os.path.exists(ck)}")
    say(f"phase 7c: killed at stream offset {pos} ({pos // STREAM_CHUNK} "
        f"chunks, {cut} output bytes), resumed in "
        f"{time.perf_counter() - t0:.3f} s: output byte-identical to the "
        f"uninterrupted scan, checkpoint removed")

    # 7b: the stateful kinds, streamed and buffered, feed on and off
    stateful_scans(dev, tmp, dst)

    peak = {r: max(p for _w, p in walls[r]) for r in ("streamed", "buffered")}
    say(f"phase 7 on {card_line()}: {what}, wall s min / median / max of 3 in "
        f"turns: streamed (stdin, {STREAM_CHUNK // MIB} MiB chunks) "
        f"{mmm(w for w, _p in walls['streamed'])}, buffered "
        f"{mmm(w for w, _p in walls['buffered'])}, run_host "
        f"{mmm(w for w, _p in walls['run_host'])}; peak device memory "
        f"streamed {peak['streamed']} bytes, buffered {peak['buffered']} "
        f"bytes; child processes: feed on {peak_on}, feed off {peak_off}; "
        f"swar_counts launches in one scan: streamed feed on "
        f"{launches['streamed']}, buffered feed on {launches['buffered']}, "
        f"streamed feed off {n_off}")
    if peak["streamed"] >= peak["buffered"]:
        raise AssertionError("the streamed scan's peak device memory is not "
                             "below the buffered scan's")


def mmm(xs):
    xs = sorted(xs)
    return f"{xs[0]:.3f} / {xs[len(xs) // 2]:.3f} / {xs[-1]:.3f}"


class feed_env:
    """STRINGSEXT_RUNTABLE_FEED set to `value` inside the block."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = os.environ.get("STRINGSEXT_RUNTABLE_FEED")
        os.environ["STRINGSEXT_RUNTABLE_FEED"] = self.value

    def __exit__(self, *_exc):
        if self.saved is None:
            os.environ.pop("STRINGSEXT_RUNTABLE_FEED", None)
        else:
            os.environ["STRINGSEXT_RUNTABLE_FEED"] = self.saved


def stateful_scans(dev, tmp, dst):
    """Phase 7b: the stateful set over `stateful_corpus`, streamed and
    buffered, feed on and off, in three turns with `run_host`; then the
    256 MiB streamed scan, feed on."""
    from stringsext_tpu_torch.corpus import STATEFUL_ENCODINGS, stateful_corpus
    from stringsext_tpu_torch.ops import classify_cjk, swar
    from stringsext_tpu_torch.run import STREAM_CHUNK

    ssrc = os.path.join(tmp, "stateful.bin")
    stateful_corpus(STATEFUL_SIZE, seed=0).tofile(ssrc)
    sargv = ["-t", "x", "-u", "Asian"] + [a for e in STATEFUL_ENCODINGS
                                         for a in ("-e", e)]
    swhat = f"{STATEFUL_SIZE // MIB} MiB {'+'.join(STATEFUL_ENCODINGS)}"
    kernels = {"swar_counts": swar.swar_counts,
               "orbit_resolve": classify_cjk._orbit_mask_blocked}
    routes = ("run_host", "streamed, feed on", "buffered, feed on",
              "streamed, feed off", "buffered, feed off")
    outs, walls, peaks, seen = set(), {}, {}, {}
    for turn in range(3):
        for route in routes:
            streamed = route.startswith("streamed")
            for fn in kernels.values():
                fn.launches = 0
            stats = []
            with feed_env("0" if route.endswith("off") else "1"):
                outs.add(cli_scan(
                    f"7b turn {turn + 1}, {swhat}, {route}",
                    sargv + ([] if streamed else [ssrc]), dst,
                    None if route == "run_host" else dev,
                    stdin_path=ssrc if streamed else None, stats=stats))
            walls.setdefault(route, []).append(stats[0][0])
            peaks[route] = max(peaks.get(route, 0), stats[0][1])
            if route == "run_host":
                continue
            n = {k: fn.launches for k, fn in kernels.items()}
            seen[route] = n
            need = "orbit_resolve" if route.endswith("on") else "swar_counts"
            if not n[need]:
                raise AssertionError(f"7b {route}: {need} never ran ({n})")
            if route.endswith("off") and n["orbit_resolve"]:
                raise AssertionError(f"7b {route}: the orbit ran without "
                                     f"the feed")
            if turn == 0:
                count_launches(f"cli stateful set {route}, "
                               f"{STATEFUL_SIZE // MIB} MiB",
                               {k: fn for k, fn in kernels.items()
                                if fn.launches})
    if len(outs) != 1 or next(iter(outs))[0] < STATEFUL_SIZE // 8:
        raise AssertionError(f"7b: outputs differ or are empty: {outs}")

    big = os.path.join(tmp, "stateful-big.bin")
    stateful_corpus(STATEFUL_STREAM_SIZE, seed=0).tofile(big)
    for fn in kernels.values():
        fn.launches = 0
    stats = []
    cli_scan(f"7b {STATEFUL_STREAM_SIZE // MIB} MiB stateful set, streamed "
             f"from a pipe, feed on", sargv, dst, dev, stdin_path=big,
             stats=stats)
    os.unlink(big)
    big_peak = stats[0][1]
    n_big = {k: fn.launches for k, fn in kernels.items()}
    if not n_big["orbit_resolve"]:
        raise AssertionError(f"7b 256 MiB: the orbit never ran ({n_big})")
    small_peak = peaks["streamed, feed on"]
    if big_peak > small_peak + 2 * STREAM_CHUNK:
        raise AssertionError(f"7b: streamed peak grew with the stream: "
                             f"{big_peak} bytes at {STATEFUL_STREAM_SIZE} "
                             f"against {small_peak} at {STATEFUL_SIZE}")
    say(f"phase 7b on {card_line()}: {swhat}, all byte-identical to "
        f"run_host; wall s min / median / max of 3 in turns: "
        + "; ".join(f"{r} {mmm(walls[r])}" for r in routes)
        + "; peak device memory "
        + ", ".join(f"{r} {peaks[r]}" for r in routes[1:])
        + f" bytes; launches in one scan {seen}; streamed "
        f"{STATEFUL_STREAM_SIZE // MIB} MiB feed on: peak {big_peak} bytes, "
        f"launches {n_big}")


def phase_two_files(dev, tmp):
    """Phase 8: a buffered stream of 2 GiB or more, feed on."""
    from stringsext_tpu_torch.corpus import sparse_corpus

    files = []
    for k in range(2):
        files.append(os.path.join(tmp, f"two-{k}.bin"))
        sparse_corpus(TWO_FILE_SIZE).tofile(files[-1])
    argv = ["-t", "x", "-e", "UTF-8"] + files
    dst = os.path.join(tmp, "two.out")
    what = f"8 two files of {TWO_FILE_SIZE} bytes, -e UTF-8, buffered"
    with feed_env("1"):
        port = cli_scan(f"{what}, port on the card, feed on", argv, dst, dev)
    host = cli_scan(f"{what}, run_host", argv, dst)
    for f in files:
        os.unlink(f)
    if port != host or port[0] < 100:
        raise AssertionError(f"8: {port} != {host}")
    say(f"phase 8: the {2 * TWO_FILE_SIZE}-byte buffered scan is "
        f"byte-identical to run_host")


def lanes_corpora(big):
    import numpy as np

    pairs = np.array([[i, j] for i in range(256) for j in range(256)],
                     np.uint8).reshape(-1)
    edges = edge_corpus(len(big), seed=5)
    return {
        f"bench-{len(big) // MIB}MiB": big,
        "byte-pairs": pairs,
        "all-0x00": np.zeros(MIB, np.uint8),
        "all-0xFF": np.full(MIB, 0xFF, np.uint8),
        "seams-96-rows": seam_corpus(),
        "unpadded-edges-32-rows": edge_corpus(4096, seed=3),
        "unpadded-edges-64-rows": edge_corpus(8192, seed=4),
        "unpadded-edges-1MiB": edge_corpus(MIB, seed=2),
        f"unpadded-edges-{len(big) // MIB}MiB": edges,
    }


def phase_step(dev, big):
    """Phase 5."""
    from stringsext_tpu_torch import entry as step_mod
    from stringsext_tpu_torch.corpus import (
        SWAR_LANES_FILTERS,
        flagship_missions,
        make_corpus,
        sparse_corpus,
        swar_lanes_corpora,
    )
    from stringsext_tpu_torch.ops import scan, swar

    flagship = flagship_missions()
    grep = flagship_missions(flag_grep_char="63")
    many = flagship_missions(flag_ascii_filter="0x" + "5" * 32)
    assert swar.swar_params(many.v) is None

    # (a) each kernel against its plain version, bit for bit
    swar_sets = {name: swar.swar_params(flagship_missions(**kw).v)
                 for name, kw in SWAR_LANES_FILTERS.items()}
    both = lanes_corpora(big)  # whole 4096-byte blocks: both kernels take them
    ncmp = 0
    for cname, raw in {**both, **swar_lanes_corpora()}.items():
        b = torch.from_numpy(raw).to(dev)
        w = b.view(torch.int32).reshape(-1, 128)
        for sname, p in swar_sets.items():
            got = swar.flagship_swar_lanes(w, **p)
            want = swar.flagship_swar_lanes_ref(w, **p)
            for mi, (g, x) in enumerate(zip(got, want)):
                check_equal("flagship_swar_lanes",
                            f"{cname} / {sname} mission {mi}", g, x)
            ncmp += 1
        if cname not in both:
            say(f"  {cname}: flagship_swar_lanes == plain for "
                f"{', '.join(swar_sets)}")
            continue
        for mname, ms in (("flagship", flagship), ("grep", grep),
                          ("many", many)):
            params = scan.flagship_params(ms.v)
            d = b.reshape(-1, 128)
            check_equal("flagship_mission_lanes", f"{cname} / {mname}",
                        scan.flagship_mission_lanes(d, params),
                        scan.flagship_mission_lanes_ref(d, params))
            ncmp += 1
        say(f"  {cname}: flagship_swar_lanes == plain for "
            f"{', '.join(swar_sets)}; flagship_mission_lanes == plain for "
            f"flagship, grep and >12-interval params")
    off = torch.zeros(128 * 8 + 1, dtype=torch.int32, device=dev)[1:]
    try:
        swar.flagship_swar_lanes(off.reshape(8, 128), **swar_sets["flagship"])
    except ValueError:
        pass
    else:
        raise AssertionError("flagship_swar_lanes took words that are not "
                             "16-byte aligned")
    say(f"phase 5a: {ncmp} kernel comparisons, max abs difference "
        f"{max(RESULTS[k]['err'] for k in RESULTS)} (tolerance 0)")

    # (b) the routes agree; each launches exactly its kernels
    counters = {"swar_counts": swar.swar_counts,
                "flagship_swar_lanes": swar.flagship_swar_lanes,
                "flagship_mission_lanes": scan.flagship_mission_lanes}
    expect = {"swar": {"swar_counts"},
              "swar-lanes": {"flagship_swar_lanes"},
              "lanes": {"flagship_mission_lanes"}, "plain": set()}

    def run_routes(data, ms, routes, capacity, xor_word=None):
        out = {}
        for r in routes:
            step, _ = step_mod.entry(dev, route=r, missions=ms,
                                     capacity=capacity)
            for fn in counters.values():
                fn.launches = 0
            out[r] = step.tables(data, xor_word=xor_word)
            torch.cuda.synchronize()
            seen = {k: fn.launches for k, fn in counters.items()}
            if ({k for k, n in seen.items() if n} != expect[r]
                    or max(seen.values()) > 1):
                raise AssertionError(f"route {r} launched {seen}")
            count_launches(f"step route {r}",
                           {k: counters[k] for k in expect[r]})
        ref = out[routes[-1]]
        for r in routes:
            for mi, (a, x) in enumerate(zip(out[r], ref)):
                for f in a._fields:
                    if not torch.equal(getattr(a, f), getattr(x, f)):
                        raise AssertionError(
                            f"route {r} != {routes[-1]}: mission {mi} {f}")
        return ref

    data = torch.from_numpy(big).to(dev)
    what = f"{SIZE // MIB} MiB"
    for xw in (None, 0x01010101):
        ref = run_routes(data, flagship, step_mod.ROUTES, 1024, xw)
        say(f"  bench {what} xor={xw}: 4 routes agree; runs "
            f"{[int(t.count) for t in ref]} overflow "
            f"{[bool(t.overflow) for t in ref]}")
    sparse = torch.from_numpy(sparse_corpus(SIZE)).to(dev)
    ref = run_routes(sparse, flagship, step_mod.ROUTES, 1 << 15)
    if any(bool(t.overflow) for t in ref):
        raise AssertionError("the sparse corpus overflowed its capacity")
    say(f"  sparse {what}, capacity {1 << 15}: 4 routes agree on every "
        f"run; runs {[int(t.count) for t in ref]}")
    if step_mod.entry(dev, missions=many)[0].route != "lanes":
        raise AssertionError("a >12-interval mission set must take lanes")
    ref = run_routes(data, many, ("lanes", "plain"), 1024)
    say(f"  >12-interval filters, bench {what}: lanes == plain; runs "
        f"{[int(t.count) for t in ref]}")
    say("phase 5b: routes agree; launches by route "
        + str({k: RESULTS[k]["launches"] for k in counters}))

    # (c) step timings and peak memory
    say(f"phase 5c timings on {card_line()} (CUDA events, 20 single steps)")
    for r in step_mod.ROUTES:
        step, _ = step_mod.entry(dev, route=r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(data)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: step(data, xor_word=0x01010101), inner=1)
        say(f"step route {r} {what}: min/median/max {ms[0]:.4f} / {ms[1]:.4f}"
            f" / {ms[2]:.4f} ms ({len(big) / (ms[1] * 1e-3) / 1e9:.2f} GB/s),"
            f" peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    del data, sparse
    larger = torch.from_numpy(make_corpus(2 * SIZE, seed=0)).to(dev)
    step, _ = step_mod.entry(dev)
    ms = cuda_ms(lambda: step(larger, xor_word=0x01010101), inner=1)
    say(f"step route swar {2 * SIZE // MIB} MiB: min/median/max {ms[0]:.4f} "
        f"/ {ms[1]:.4f} / {ms[2]:.4f} ms "
        f"({2 * SIZE / (ms[1] * 1e-3) / 1e9:.2f} GB/s)")


def mission_calls(ms):
    """(kernel name, kernel call, plain call) of the per-mission kernel of
    every mission in `ms`, each a function of the [R, 128] data."""
    from stringsext_tpu_torch.encodings import encoding_kind
    from stringsext_tpu_torch.ops import scan
    from stringsext_tpu_torch.ops.runs import filter_words

    out = []
    for m in ms:
        kind = encoding_kind(m.encoding_name)
        kw = {"grep_char": -1 if m.filter.grep_char is None
              else m.filter.grep_char}
        if kind == "single-byte":
            name = "single_byte_mission_lanes"
            kw["accept_words"], kw["valid_words"] = \
                scan.single_byte_mission_tables(m)
        else:
            name = "utf8_mission_lanes" if kind == "utf8" else \
                "utf16_mission_lanes"
            kw["af_words"], kw["ubf_words"] = filter_words(m)
            if kind != "utf8":
                kw["big_endian"] = kind == "utf16be"
        out.append((name, functools.partial(getattr(scan, name), **kw),
                    functools.partial(getattr(scan, name + "_ref"), **kw)))
    return out


def phase_lanes(dev, tmp, big, iters=5):
    """Phase 6."""
    from stringsext_tpu_torch import profile_device
    from stringsext_tpu_torch.corpus import make_corpus, sparse_corpus
    from stringsext_tpu_torch.encodings import encoding_kind
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops import classify, scan, swar
    from stringsext_tpu_torch.ops.runs import (
        extract_runs,
        extract_runs_packed,
        filter_words,
    )

    size = len(big)
    kernels = {"utf8_mission_lanes": scan.utf8_mission_lanes,
               "utf16_mission_lanes": scan.utf16_mission_lanes,
               "single_byte_mission_lanes": scan.single_byte_mission_lanes}
    sbyte = ("windows-1251", "KOI8-R", "macintosh")
    sets = {grep: Missions.new(flag_encoding=["UTF-8", "UTF-16LE", "UTF-16BE",
                                              *sbyte], flag_grep_char=grep).v
            for grep in (None, "63")}

    # (a) each kernel against its plain version, and against the
    # flagship kernel's fields
    ncmp = 0
    for cname, raw in lanes_corpora(big).items():
        d = torch.from_numpy(raw).to(dev).reshape(-1, 128)
        for grep, ms in sets.items():
            for name, kern, plain in mission_calls(ms):
                check_equal(name, f"{cname} grep={grep}", kern(d), plain(d))
                ncmp += 1
            flag = scan.flagship_mission_lanes(d, scan.flagship_params(ms))
            for shift, m in zip((0, 8, 16), ms[:3]):
                got = scan.mission_lanes(d, m)
                torch.cuda.synchronize()
                if not torch.equal(got, (flag >> shift) & 0x7F):
                    raise AssertionError(
                        f"{m.encoding_name} field on {cname} != "
                        f"flagship_mission_lanes bits {shift}-{shift + 6}")
                ncmp += 1
        say(f"  {cname}: the three kernels == plain, fields == flagship")
    say(f"phase 6a: {ncmp} comparisons, max abs difference "
        f"{max(RESULTS[k]['err'] for k in kernels)} (tolerance 0)")

    # (b) the pipeline's kernel route against its torch route
    def torch_route(b, m, capacity):
        n = b.numel()
        kind = encoding_kind(m.encoding_name)
        if kind == "utf8":
            lanes = classify.utf8_lanes(b, n)
        elif kind in ("utf16le", "utf16be"):
            lanes = classify.utf16_lanes(b, kind == "utf16be", n)
        else:
            lanes = classify.single_byte_lanes(b, m.encoding_name, n)
        af, ubf = filter_words(m)
        g = -1 if m.filter.grep_char is None else m.filter.grep_char
        return extract_runs(lanes, af, ubf, g, capacity)

    padded = big.copy()
    padded[:128] = 0
    padded[-128:] = 0
    for cname, raw, capacity in (
            (f"bench-{size // MIB}MiB", padded, 1024),
            (f"sparse-{size // MIB}MiB", sparse_corpus(size), 1 << 15)):
        b = torch.from_numpy(raw).to(dev)
        counts = []
        for m in sets["63"]:
            want = torch_route(b, m, capacity)
            for fn in kernels.values():
                fn.launches = 0
            got = extract_runs_packed(scan.mission_lanes(b.reshape(-1, 128), m),
                                      capacity)
            torch.cuda.synchronize()
            count_launches("per-mission kernel route", kernels)
            for f in got._fields:
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"{m.encoding_name} on {cname}: "
                                         f"kernel route != torch route ({f})")
            counts.append(int(got.count))
        say(f"  {cname}, capacity {capacity}: kernel route == torch route; "
            f"runs {counts}")
    route = {k: RESULTS[k]["launches"]["per-mission kernel route"]
             for k in kernels}
    if not all(route.values()):
        raise AssertionError(f"the kernel route skipped a kernel: {route}")
    say(f"phase 6b: run tables agree; kernel-route launches {route}")
    del d, flag, got, want, b  # so that 6c's peaks are the scans' own

    # (c) the CLI's lanes fallback against the port's host path
    src = os.path.join(tmp, "lanes.bin")
    make_corpus(BUFFERED_SIZE, seed=0).tofile(src)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE",
            "-a", "0x" + "5" * 32, src]
    dst = os.path.join(tmp, "lanes.out")
    what = f"lanes fallback, {BUFFERED_SIZE // MIB} MiB"
    outs = {"host": cli_scan(f"{what}, port host path (whole stream, no hot "
                             f"map)", argv, dst)}
    for feed in ("1", "0"):
        swar.swar_counts.launches = 0
        with feed_env(feed):
            outs[feed] = cli_scan(f"{what}, port on the card, feed "
                                  f"{'on' if feed == '1' else 'off'}", argv,
                                  dst, dev)
        if swar.swar_counts.launches:
            raise AssertionError("swar_counts ran for missions without "
                                 "a swar spec")
    if len(set(outs.values())) != 1:
        raise AssertionError(f"lanes-fallback output differs: {outs}")
    say("phase 6c: outputs byte-identical with the feed on and off; "
        "swar_counts launches 0")

    # (d) the device profiler
    prof = {"utf8_mission_lanes": scan.utf8_mission_lanes,
            "flagship_swar_lanes": swar.flagship_swar_lanes}
    for fn in prof.values():
        fn.launches = 0
    res = profile_device.profile(size, iters, dev, out=lambda line: say(
        "  " + line))
    torch.cuda.synchronize()
    bad = [r["name"] for r in res if "ms" not in r]
    if len(res) != 6 or bad:
        raise AssertionError(f"profiler variants failed: {bad}")
    seen = {k: fn.launches for k, fn in prof.items()}
    if not all(seen.values()):
        raise AssertionError(f"the profiler skipped a kernel: {seen}")
    count_launches(f"profiler, {iters} iterations", prof)
    say(f"phase 6d: six profiler variants reported; launches {seen}")


def time_lanes_kernels(dev, big):
    """Kernels #2-#6 and their plain versions at SIZE: each reads the
    stream once and writes one int32 a byte (three words a word for
    `flagship_swar_lanes`)."""
    from stringsext_tpu_torch.corpus import (
        SWAR_LANES_FILTERS,
        flagship_missions,
    )
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops import scan, swar

    n = len(big)
    data = torch.from_numpy(big).to(dev)
    u8 = data.reshape(-1, 128)
    w = data.view(torch.int32).reshape(-1, 128)
    flagship = flagship_missions()
    p = swar.swar_params(flagship.v)
    params = scan.flagship_params(flagship.v)
    what = f"{n // MIB} MiB"
    for sname in ("grep", "astral", "twelve"):
        q = swar.swar_params(flagship_missions(**SWAR_LANES_FILTERS[sname]).v)
        t = cuda_ms(lambda: swar.flagship_swar_lanes(w, **q))
        say(f"flagship_swar_lanes {what}, filter set {sname}: kernel min/"
            f"median/max {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} ms a launch in "
            f"runs of 10")
    time_kernel("flagship_swar_lanes", f"flagship_swar_lanes {what}",
                lambda: swar.flagship_swar_lanes(w, **p),
                lambda: swar.flagship_swar_lanes_ref(w, **p), n + 3 * n)
    time_kernel("flagship_mission_lanes", f"flagship_mission_lanes {what}",
                lambda: scan.flagship_mission_lanes(u8, params),
                lambda: scan.flagship_mission_lanes_ref(u8, params),
                n + 4 * n)
    ms = Missions.new(flag_encoding=["UTF-8", "UTF-16LE", "UTF-16BE",
                                     "windows-1251"]).v
    for (name, kern, plain), m in zip(mission_calls(ms), ms):
        label = f"{name} ({m.encoding_name}) {what}"
        if m.encoding_name == "UTF-16BE":  # one entry a kernel: LE's
            t = cuda_ms(lambda: kern(u8))
            say(f"{label}: kernel min/median/max {t[0]:.4f} / {t[1]:.4f} / "
                f"{t[2]:.4f} ms a launch in runs of 10")
            continue
        time_kernel(name, label, lambda: kern(u8), lambda: plain(u8),
                    n + 4 * n)


def time_orbit(dev, stateful):
    """The orbit kernel and its plain version on the step fields of the
    feed's 64 MiB pieces and of an 8 MiB piece (the streamed chunk):
    int32 steps read once and a bool mask written once make its bound."""
    from stringsext_tpu_torch.ops.classify_cjk import (
        _orbit_mask_blocked,
        _orbit_mask_blocked_ref,
    )

    steps = piece_steps(stateful, dev)
    for enc, (step, n, start) in steps.items():
        cap = step.numel()
        label = f"orbit_resolve, {enc} piece of {cap} bytes"
        if enc != "Shift_JIS":
            t = cuda_ms(lambda: _orbit_mask_blocked(step, n, start))
            say(f"{label}: kernel min/median/max {t[0]:.4f} / {t[1]:.4f} / "
                f"{t[2]:.4f} ms a launch in runs of 10")
            continue
        time_kernel("orbit_resolve", label,
                    lambda: _orbit_mask_blocked(step, n, start),
                    lambda: _orbit_mask_blocked_ref(step, n, start), 5 * cap)
    step, n, start = chunk_steps(stateful, dev)
    t = cuda_ms(lambda: _orbit_mask_blocked(step, n, start))
    plain = cuda_ms(lambda: _orbit_mask_blocked_ref(step, n, start), inner=1)
    bound = 5 * step.numel() / HBM_BYTES_PER_S * 1e3
    say(f"orbit_resolve, Shift_JIS 8 MiB piece of {step.numel()} bytes: "
        f"kernel min/median/max {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} ms a "
        f"launch in runs of 10; bound {bound:.4f} ms ({100 * bound / t[1]:.0f}"
        f"% reached); plain torch min/median/max {plain[0]:.4f} / "
        f"{plain[1]:.4f} / {plain[2]:.4f} ms")


def kernels_line():
    out = []
    for name, (source, replaces) in KERNELS.items():
        r = RESULTS[name]
        if not r["launches"] or not all(r["launches"].values()):
            raise AssertionError(f"{name} was not launched on a main path: "
                                 f"{r['launches']}")
        out.append({
            "name": name, "route": "cuda",
            "source": f"stringsext_tpu_torch/csrc/{source}",
            "replaces": f"stringsext_tpu/ops/{replaces}",
            "launches": sum(r["launches"].values()),
            "launches_by_path": r["launches"],
            "max_abs_err": r["err"],
            "ms": r["ms"][1], "ms_min": r["ms"][0], "ms_max": r["ms"][2],
            "single_launch_ms": r["single_ms"],
            "plain_ms": r["plain_ms"][1],
            "bound_ms": r["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes it
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import stringsext_tpu_torch  # noqa: F401  (fails outside a checkout)
    from stringsext_tpu_torch.corpus import stateful_corpus

    say(card_line())  # name, power limit
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = None
    try:
        phase_build(dev)
        stateful = stateful_corpus(STATEFUL_SIZE, seed=0)
        pool, oracles = start_oracles(stateful)
        big, trio, other_sets = phase_kernel(dev)
        phase_orbit(dev, stateful)
        phase_feeds(dev, stateful, oracles)
        pool.shutdown()
        phase_main_path(dev, tmp)
        phase_goldens(dev, tmp)
        phase_step(dev, big)
        phase_lanes(dev, tmp, big)
        phase_streaming(dev, tmp)
        phase_two_files(dev, tmp)
        say(f"kernel timings on {card_line()}")
        time_swar_counts(dev, big, trio, other_sets)
        time_lanes_kernels(dev, big)
        time_orbit(dev, stateful)
    finally:
        if pool is not None:  # waits for a running oracle when a phase failed
            pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "stringsext_tpu", "bench",
                                     "__graft_entry__")]
    if loaded:
        raise AssertionError(f"imported {loaded}")
    say(card_line())
    say(json.dumps(kernels_line()))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
