"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once at real size and checks them, in
thirteen phases; any failure exits non-zero before the result line is
printed:

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
   and ISO-2022-JP's last-set scan `_scan_last_sets` (CUDA,
   `csrc/last_set_scan.cu`) must equal its plain version
   `_scan_last_set_ref` (`torch.cummax`) bit for bit, lane by lane, on the
   mode and flag transfer lanes of the feed's ISO-2022-JP pieces of that
   corpus (its first 64 MiB, an 8 MiB piece from its middle with its
   context) and of bytes with escape fragments planted densely (one a 40
   bytes) and sparsely (one a MiB) at 8 MiB + 12 and 64 MiB, each with the
   lanes swapped and sliced 4 bytes in; at n = 1, 2, 17, one below, at and
   one above 1, 2, 3 and 40 tiles of 4096, and 8 MiB + 12, with nothing
   set, everything set, values up to 2**31 - 1 and values only at the
   tiles' edges; and on two launches back to back over different data;
   (2d) the feed's report clamp `_report_clamp` (CUDA,
   `csrc/report_clamp.cu`) must equal its plain version `_report_clamp_ref`
   (`torch.cummax`) bit for bit, the mask and the last running max, at
   n = 1, a tile of 4096 less one, a tile, a tile and one, 8 MiB, 8 MiB + 6
   and 64 MiB, on random lanes with no event, every position an event,
   reports past the chars' last bytes, with a carried max of -1, inside
   the piece and past its end; on lanes sliced 1, 2, 4 and 16 positions
   into their allocations; on the lanes of the trio's feed pieces of the 64
   MiB bench corpus (the whole, an 8 MiB piece from its middle, its last 8
   MiB + 6); and on two launches back to back over different data;
3. the buffered main path - the port's CLI scan
   (`stringsext_tpu_torch.run.run`, device "cuda") of a 64 MiB bench
   corpus by name with UTF-8 + UTF-16LE +
   UTF-16BE must write the same bytes as the port's host path
   (`run.run_host`: the whole stream through the C++ emitter, no hot
   map); the launch counters of `swar_counts` and of the report clamp are
   reset just before the port's run and must be positive after it;
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
   byte-identical to `run_host`, the orbit kernel, the report clamp and
   the last-set scan launched by every scan with the feed on and none of
   them with it off, `swar_counts` by every scan with it off; and one
   streamed scan of 256 MiB of that corpus from a pipe, feed on, whose
   peak device memory must not pass the 64 MiB streamed scan's by more
   than two chunks (16 MiB); (c)
   `--checkpoint`: the child killed with SIGKILL after its third saved
   chunk and the same command run again must leave the uninterrupted
   scan's bytes and no checkpoint file;
8. inputs of 2 GiB or more - two files of 1.1 GiB each
   (`corpus.sparse_corpus`), `-e UTF-8`, scanned buffered on the card with
   the feed on (their stream is 2.2 GiB), must give `run_host`'s bytes;
9. the mesh (`stringsext_tpu_torch/parallel/mesh.py`), on a virtual mesh
   of several shards on the one card - (a) `swar_counts` sharded over 4
   and 8 shards of the 128 MiB trio corpus (`build_sharded_counts`) must
   equal one pass bit for bit, with and without hot_only, launching the
   kernel once a shard; on a host with several cards, also over 1..N real
   cards, a weak-scaling row for each; (b) Shift_JIS + gb18030 +
   ISO-2022-JP + UTF-8 on a 4 x 4 mesh over the 64 MiB stateful corpus
   (`build_sharded_scan`, 16 MiB shards, a table capacity above the most
   runs of any shard): the stitched tables must equal the single-device
   scan's runs, their hot ranges must make the emitter write `run_host`'s
   bytes, every stage-C probe set of the orbit kernel must equal
   `_orbit_masks_block0`, the orbit kernel must launch 5 times a chain
   cell and the last-set scan must launch; a second run is timed with its
   peak device memory; (c) the
   `--mesh` CLI with `run.mesh_devices` answering 4 shards, feed off,
   buffered and streamed from a pipe, in three turns with the unsharded
   feed-off scans and `run_host`: all byte-identical, the sharded scans
   launching `swar_counts` 4 times as often; (d)
   `entry.dryrun_multichip(8, cuda)`. On a host with several cards, (b)
   runs once more with data row d on card d % N, and (c) adds the scans
   over every card, the default there;
10. the multi-process scan (`stringsext_tpu_torch/parallel/distributed.py`)
   - N rank processes of `python -m stringsext_tpu_torch --device cuda
   --dist-nprocs N --dist-rank K --dist-coord 127.0.0.1:PORT`, started
   together, N = 2 (both on cuda:0 with one card; rank k on card k % the
   card count), under STRINGSEXT_PROFILE=1 so that each rank prints its
   device, shard, bytes read, `swar_counts` and orbit launches, scan wall
   and peak device memory. Rank 0's bytes must equal `run_host`'s, the
   other ranks' stdout must stay empty, a failing rank fails the case
   (the others are killed; every case has a time limit): (a) the flagship
   trio over the 128 MiB bench corpus (random bytes: no quiescent row, so
   rank 0 takes the whole input as in the reference) feed off, and over
   `corpus.sparse_corpus(128 MiB)` (a real split) feed on through
   stdout and feed off through `-p FILE`; (b) the stateful set over the
   64 MiB stateful corpus, feed on and off, both shards non-empty; (c)
   phase 8's two files of 1.1 GiB, `-e UTF-8`, feed on; (d) `--checkpoint`
   with 8 MiB chunks over the sparse corpus, both ranks stopped by
   STRINGSEXT_DIST_CKPT_DIE=2, then the same command resumed: `run_host`'s
   bytes, chunks skipped, no `.rankK` file left. `swar_counts` must launch
   in every rank with a non-empty shard where the feed is off, the orbit
   kernel in (b) with the feed on, and on the sparse corpora every rank
   must read under 0.75 of the input. Each case's wall is printed beside
   the single-process buffered scan's and `run_host`'s. With several
   cards, (a) on the sparse corpus and (b) run once more with one rank a
   card;
11. the engine choice (`--engine auto|tpu|python`), with the probe's cache
   in a file of the phase's own - (a) the link probe's child on the card
   must measure at least 2 GB/s and at most 50 ms, and `_auto_engine` from
   an empty cache must say "tpu" and write a document tagged "backend":
   "torch"; a second call must answer from the cache without a child, and
   a document without the tag (the JAX package's) must be measured anew;
   (b) `python -m stringsext_tpu_torch --engine auto` over the 64 MiB
   bench corpus with the trio, under STRINGSEXT_PROFILE=1, must write
   `run_host`'s bytes, print `engine auto -> tpu (cached, ...)` and launch
   `swar_counts`; (c) three turns of buffered scans of that corpus with
   `--engine tpu`, `--engine auto` and `--engine auto --host-hotmap` (the
   probe pinned off: the host route) and `run_host`, then each engine once
   streamed from a pipe: all byte-identical, the auto scans launching no
   kernel and leaving the card's peak memory where a reset put it; (d) the
   stateful set over the 64 MiB stateful corpus under `--engine auto` with
   and without `--host-hotmap`: `run_host`'s bytes, no launch; (e)
   `--engine python` over 1 MiB of the bench corpus: `run_host`'s bytes, no
   launch, and with `--checkpoint` exit code 1 and the reference's message;
   (f) two rank processes with `--engine auto --host-hotmap` over
   `corpus.sparse_corpus(128 MiB)`: rank 0 writes `run_host`'s bytes, and
   no rank touches the card (device "host", no launch, no memory). Every
   wall is printed, with the phase's;
12. the mesh across processes (`parallel/mesh.py::make_process_mesh`) -
   two rank processes of this script (`--pmesh-rank`, an argument for
   the ranks alone), started together on the card (rank k on card k % the
   card count), join a gloo group; each reads only its rows' bytes
   (`distributed.host_shard_range`): (a) the sharded counts of the 128 MiB
   trio corpus, 4 rows of 16 MiB a rank, must equal one `swar_counts`
   pass bit for bit with hot_only on and off, launching the kernel 4
   times a rank a call, with 2 x 4 KiB crossing each rank a call; (b) the
   scan of phase 9b (Shift_JIS + gb18030 + ISO-2022-JP + UTF-8 over the
   64 MiB stateful corpus, a 4 x 4 mesh, 2 rows a rank, 9b's capacity):
   the ranks' tables, stitched, must equal 9b's single-device runs, and
   the orbit kernel must launch 5 times a chain cell in each rank. Each
   rank's walls and peak device memory are printed beside phase 9's; a
   failing rank fails the phase (the others are killed), and so does the
   phase's limit of 150 s.
13. the port installed - (a) a copy of `stringsext_tpu_torch/` laid out
   as an install lays it out (its sources, `csrc/`, `native/emitter.cpp`
   and the encodings' tables; no built library) and a console script
   `stringsext-tpu-torch` with the body pip writes, run with a fresh
   HOME, `PYTHONPATH` at the copy and no bytecode written, from a
   directory outside the checkout, over phase 3's 64 MiB trio corpus:
   `run_host`'s bytes; the kernels' library and the emitter built into
   `HOME/.cache/stringsext-tpu-torch/kernels/` (the cold build's seconds
   printed), nothing added to the copy, `swar_counts` launched; (b)
   `scripts/cuda_smoke.py --cli` that script, in the same environment:
   configs 2-3 with `--engine tpu` byte-identical to `--engine auto`, a
   second `tpu` process that loads the cached kernels and builds nothing,
   `swar_counts` and the orbit kernel launched; (c)
   `scripts/fuzz_torch.py --device cuda` over FUZZ_TRIALS trials at seed
   14 in a child process: no failure, both kernels launched; (d) the
   port's `.deb`, built here by `scripts/build_packages_torch.py` and
   extracted with `dpkg-deb -x` (a host without dpkg-deb fails the
   phase): its launcher, run by this interpreter with (a)'s HOME over
   the same corpus, writes `run_host`'s bytes, loads both libraries from
   (a)'s cache and builds nothing, launches `swar_counts` and leaves the
   extracted tree as it was. Its launches count under the paths
   `installed`, `fuzz` and `deb`.

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
piece of the streamed path. The report clamp's bound counts 12 bytes a
position (three bool and two int32 lanes read, the mask written); it is
timed on the UTF-8 lanes of an 8 MiB and a 64 MiB trio piece, beside its
plain version and the library's `torch.cummax` + clamp + compare
(`library_ms`, the yardstick the port no longer calls). The last-set
scan's bound counts 16 bytes a position (two int32 lanes read and
written); it is timed on the ISO-2022-JP transfer lanes of phase 2c's 8
MiB and 64 MiB stateful pieces, beside its plain version and the
library's two `torch.cummax` (`library_ms`).

The script imports torch, numpy and the port; it never imports jax or
the JAX package and asserts so. Its last two lines are a JSON object
describing the kernels and `{"ok": true, "device": {...}}`.
"""

import functools
import hashlib
import io
import json
import os
import re
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
MESH_SIZE = 128 * MIB  # the flagship corpus of phase 9 (counts, --mesh CLI)
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
    "report_clamp": ("report_clamp.cu",
                     "device_events.py::runtable_feed:344 (lax.cummax)"),
    "last_set_scan": ("last_set_scan.cu",
                      "classify_iso2022.py::_scan_last_set:71 "
                      "(lax.associative_scan)"),
}
# what each phase learns about a kernel: "err", "launches" {path: n},
# "ms" (min, median, max), "single_ms", "plain_ms", "bytes", "library_ms"
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


ISO_FRAGS = [b"\x1b", b"\x1b(", b"\x1b(B", b"\x1b(I", b"\x1b(J", b"\x1b$B",
             b"\x1b$@", b"\x1b$X", b"\x1b$B\x30\x6c", b"\x0e\x0f"]


def iso_fuzz(n, every, seed):
    """Printable bytes with an ISO-2022-JP escape fragment (valid,
    invalid, truncated, a LEAD pair) planted about every `every` bytes,
    from a seed."""
    import numpy as np

    r = np.random.default_rng(seed)
    d = r.integers(0x20, 0x7F, n, np.uint8)
    for f in ISO_FRAGS:
        at = r.integers(0, max(n - len(f), 1),
                        max(n // every // len(ISO_FRAGS), 1))
        for j, byte in enumerate(f):
            d[np.minimum(at + j, n - 1)] = byte
    return d


def iso_transfers(raw, dev, effect_lo):
    """The (mode, flag) transfer lanes `iso_pre_lanes` hands the last-set
    scan over the bytes `raw`, with the effects before `effect_lo` cut as
    the feed's pieces cut them."""
    from stringsext_tpu_torch.ops.classify_iso2022 import (
        _flag_transfers,
        _iso_escapes,
        _mode_transfers,
    )

    b = torch.from_numpy(raw).to(dev).to(torch.int32)
    E = _iso_escapes(b, b.numel())
    keep = E["idx"] >= effect_lo
    return (torch.where(keep, _mode_transfers(E), -1).to(torch.int32),
            torch.where(keep, _flag_transfers(E), -1).to(torch.int32))


def last_set_edge(n, case, seed, dev):
    """An int32 lane of n positions on `dev`: "unset" (all -1), "all"
    (every position set), "big" (a hundredth set, values up to 2**31 - 1)
    or "tiles" (set only at the last and first position of every tile of
    4096)."""
    import numpy as np

    r = np.random.default_rng(seed)
    if case == "unset":
        t = np.full(n, -1)
    elif case == "all":
        t = r.integers(0, 4, n)
    elif case == "big":
        t = np.where(r.random(n) < 0.01,
                     r.integers(0, 2 ** 31 - 1, n, endpoint=True), -1)
        t[r.integers(0, n)] = 2 ** 31 - 1
    else:
        t = np.full(n, -1)
        ends = np.arange(4095, n, 4096)
        t[ends] = ends // 4096 % 4
        t[np.minimum(ends + 1, n - 1)] = 7
    return torch.from_numpy(t.astype(np.int32)).to(dev)


def stateful_iso_lanes(dev, stateful):
    """The transfer lanes of the feed's ISO-2022-JP pieces over the
    stateful corpus: {label: (t0, t1)} for its first 64 MiB piece (the
    buffered path's, effects from 0) and an 8 MiB piece from its middle
    with LEFT_CTX bytes before it and RIGHT_HALO after (the streamed
    path's chunk, effects from LEFT_CTX)."""
    from stringsext_tpu_torch.ops import device_events as de

    lo = 8 * MIB - de.LEFT_CTX
    pieces = ((stateful[:64 * MIB + de.RIGHT_HALO], 0),
              (stateful[lo:16 * MIB + de.RIGHT_HALO], de.LEFT_CTX))
    return {f"{len(raw)} bytes": iso_transfers(raw, dev, effect_lo)
            for raw, effect_lo in pieces}


def check_last_sets(dev, stateful):
    """Phase 2c's last-set scan: `_scan_last_sets` (CUDA,
    `csrc/last_set_scan.cu`) against `_scan_last_set_ref` lane by lane.
    Returns the number of lanes compared."""
    from stringsext_tpu_torch.ops import device_events as de
    from stringsext_tpu_torch.ops.classify_iso2022 import (
        _scan_last_set_ref,
        _scan_last_sets,
    )

    ncmp = 0

    def check(what, lanes, got=None):
        nonlocal ncmp
        got = got or _scan_last_sets(*lanes)
        for k, (t, g) in enumerate(zip(lanes, got)):
            want = _scan_last_set_ref(t)
            if g.dtype != want.dtype:
                raise AssertionError(f"last_set_scan on {what}: {g.dtype}")
            check_equal("last_set_scan", f"{what}, lane {k}", g, want)
            ncmp += 1

    pieces = {f"stateful corpus piece of {k}": v
              for k, v in stateful_iso_lanes(dev, stateful).items()}
    piece8 = 8 * MIB + de.LEFT_CTX + de.RIGHT_HALO
    for size in (piece8, 64 * MIB):
        for every, density in ((40, "dense"), (MIB, "sparse")):
            pieces[f"{size} fuzzed bytes, {density} escapes"] = iso_transfers(
                iso_fuzz(size, every, seed=size + every), dev, de.LEFT_CTX)
    for what, lanes in pieces.items():
        check(what, lanes)
        check(f"{what}, lanes swapped", lanes[::-1])
        check(f"{what}, sliced 4 bytes in", tuple(t[1:] for t in lanes))
    sizes = [1, 2, 17, piece8]
    for tiles in (1, 2, 3, 40):
        sizes += [tiles * 4096 - 1, tiles * 4096, tiles * 4096 + 1]
    for n in sizes:
        b = last_set_edge(n, "big", n + 1, dev)
        for case in ("unset", "all", "big", "tiles"):
            a = last_set_edge(n, case, n, dev)
            check(f"n {n} {case}", (a, b))
            check(f"n {n} {case}, lanes swapped", (b, a))
    # two launches back to back on different data, each held to its plain
    # version after both ran: a status word of the first left in the
    # second's look-back would show
    pair = [pieces[f"{piece8} fuzzed bytes, {d} escapes"]
            for d in ("dense", "sparse")]
    got = [_scan_last_sets(*lanes) for lanes in pair]
    for k, lanes in enumerate(pair):
        check(f"back-to-back launch {k}", lanes, got[k])
    return ncmp


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
    ncmp = check_last_sets(dev, stateful)
    say(f"phase 2c: the card's feeds of {', '.join(STATEFUL_FEEDS)} equal the "
        f"numpy oracle at {len(stateful) // MIB} MiB, the CPU feed and the "
        f"256 KiB pieces; {ncmp} last-set scan lanes, max abs difference "
        f"{RESULTS['last_set_scan']['err']} (tolerance 0) "
        f"({time.perf_counter() - t0:.1f} s)")


def random_clamp_lanes(dev, n, case, seed):
    """(start, pending, acc, report_off, length) on `dev` over n positions,
    from a seed: "random" (events a third of the positions, lengths 1-4,
    reports at the char's last byte), "none" (no event), "all" (every
    position an event) or "clamped" (a tenth of the reports 1-39 bytes
    past the char's last byte)."""
    import numpy as np

    r = np.random.default_rng(seed)
    length = r.integers(1, 5, n, dtype=np.int32)
    report_off = length - 1
    start = r.random(n) < 0.35
    pending = r.random(n) < 0.05
    if case == "none":
        start[:] = False
    elif case == "all":
        start[:] = True
        pending[:] = False
    elif case == "clamped":
        late = r.random(n) < 0.1
        report_off = np.where(late, report_off + r.integers(1, 40, n),
                              report_off).astype(np.int32)
    acc = start & (r.random(n) < 0.8)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (start, pending, acc, report_off, length))


def clamp_lanes(dev, data, enc, start, end):
    """The lanes the feed hands the report clamp for the piece [start,
    end) of `data` under the mission `enc` with the default filters:
    slices past the piece's context, with the accept mask."""
    from stringsext_tpu_torch.encodings import encoding_kind
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops import device_events as de
    from stringsext_tpu_torch.ops.runs import accept_mask, filter_words

    m = Missions.new(flag_encoding=[enc]).v[0]
    lanes = de._halo_piece_lanes(data, encoding_kind(m.encoding_name),
                                 m.encoding_name, start, end, dev)
    acc = accept_mask(lanes, *filter_words(m))
    return lanes.start, lanes.pending, acc, lanes.report_off, lanes.length


def phase_report_clamp(dev, big):
    """Phase 2d: the report clamp kernel against its plain version."""
    from stringsext_tpu_torch.ops.device_events import (
        _report_clamp,
        _report_clamp_ref,
    )

    ncmp = 0

    def check(what, lanes, lo, got=None):
        nonlocal ncmp
        got, last = got or _report_clamp(*lanes, lo)
        want, want_last = _report_clamp_ref(*lanes, lo)
        check_equal("report_clamp", what, got, want)
        check_equal("report_clamp", f"{what}, last max", last.reshape(1),
                    want_last.reshape(1))
        ncmp += 1
        return got

    tile = 4096
    for n in (1, tile - 1, tile, tile + 1, 8 * MIB, 8 * MIB + 6, 64 * MIB):
        for case in ("random", "none", "all", "clamped"):
            lanes = random_clamp_lanes(dev, n, case, seed=n)
            for lo in (-1, n // 2, n + 5):
                check(f"n {n} {case} lo {lo}", lanes, lo)
    wide = random_clamp_lanes(dev, 8 * MIB + 64, "clamped", seed=3)
    for off in (1, 2, 4, 16):
        check(f"lanes sliced {off} positions in",
              tuple(t[off:] for t in wide),
              100)
    feedable = 0
    for enc in ("UTF-8", "UTF-16LE", "UTF-16BE"):
        for s, e in ((0, 64 * MIB), (8 * MIB, 16 * MIB),
                     (len(big) - 8 * MIB - 6, len(big))):
            lanes = clamp_lanes(dev, big, enc, s, e)
            for lo in (-1, 3, (e - s) // 2):
                feedable += int(check(f"{enc} piece [{s}, {e}) lo {lo}",
                                      lanes, lo).sum())
    # two launches back to back on different data, each held to its plain
    # version after both ran: a status word of the first left in the
    # second's look-back would show
    pair = [random_clamp_lanes(dev, 8 * MIB, "clamped", seed=k)
            for k in (11, 12)]
    got = [_report_clamp(*lanes, -1) for lanes in pair]
    for k, lanes in enumerate(pair):
        check(f"back-to-back launch {k}", lanes, -1, got[k])
    say(f"phase 2d: {ncmp} report clamp comparisons ({feedable} feedable "
        f"chars in the trio pieces), max abs difference "
        f"{RESULTS['report_clamp']['err']} (tolerance 0)")


def time_report_clamp(dev, big):
    """The report clamp on the UTF-8 lanes of a trio piece of 8 MiB (the
    streamed chunk) and of 64 MiB (the buffered piece): the kernel, its
    plain version, and the library's `torch.cummax` + clamp + compare."""
    from stringsext_tpu_torch.ops.device_events import (
        _report_clamp,
        _report_clamp_ref,
    )

    for s, e in ((8 * MIB, 16 * MIB), (0, 64 * MIB)):
        n = e - s
        lanes = clamp_lanes(dev, big, "UTF-8", s, e)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        rep = torch.where(lanes[0] & ~lanes[1], idx + lanes[3], -1)
        target = idx + lanes[4] - 1
        lib = cuda_ms(lambda: torch.clamp(torch.cummax(rep, dim=0).values,
                                          min=-1) == target, reps=10, inner=1)
        label = f"report_clamp, UTF-8 trio piece of {n} bytes"
        kern = functools.partial(_report_clamp, *lanes, -1)
        plain = functools.partial(_report_clamp_ref, *lanes, -1)
        if n == 64 * MIB:
            time_kernel("report_clamp", label, kern, plain, 12 * n)
            RESULTS["report_clamp"]["library_ms"] = lib[1]
        else:
            t = cuda_ms(kern)
            single = cuda_ms(kern, inner=1)[1]
            bound = 12 * n / HBM_BYTES_PER_S * 1e3
            say(f"{label}: kernel min/median/max {t[0]:.4f} / {t[1]:.4f} / "
                f"{t[2]:.4f} ms a launch in runs of 10 (single launches: "
                f"median {single:.4f}); bound {bound:.4f} ms "
                f"({100 * bound / t[1]:.0f}% reached)")
        say(f"{label}: library torch.cummax + clamp + compare min/median/max "
            f"{lib[0]:.4f} / {lib[1]:.4f} / {lib[2]:.4f} ms")


def time_last_set_scan(dev, stateful):
    """The last-set scan on the transfer lanes of the stateful corpus's
    ISO-2022-JP pieces of 8 MiB (the streamed chunk) and of 64 MiB (the
    buffered piece): the kernel, its plain version, and the library's two
    `torch.cummax` (one a lane, over the positions that hold a value)."""
    from stringsext_tpu_torch.ops.classify_iso2022 import (
        _scan_last_set_ref,
        _scan_last_sets,
    )

    for label, (t0, t1) in sorted(stateful_iso_lanes(dev, stateful).items(),
                                  key=lambda kv: kv[1][0].numel()):
        n = t0.numel()
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        w0, w1 = (torch.where(t >= 0, idx, -1) for t in (t0, t1))
        lib = cuda_ms(lambda: (torch.cummax(w0, dim=0),
                               torch.cummax(w1, dim=0)), reps=10, inner=1)
        label = f"last_set_scan, ISO-2022-JP lanes of a piece of {label}"
        kern = functools.partial(_scan_last_sets, t0, t1)
        if n > 32 * MIB:
            time_kernel("last_set_scan", label, kern,
                        lambda: (_scan_last_set_ref(t0),
                                 _scan_last_set_ref(t1)), 16 * n)
            RESULTS["last_set_scan"]["library_ms"] = lib[1]
        else:
            t = cuda_ms(kern)
            single = cuda_ms(kern, inner=1)[1]
            bound = 16 * n / HBM_BYTES_PER_S * 1e3
            say(f"{label}: kernel min/median/max {t[0]:.4f} / {t[1]:.4f} / "
                f"{t[2]:.4f} ms a launch in runs of 10 (single launches: "
                f"median {single:.4f}); bound {bound:.4f} ms "
                f"({100 * bound / t[1]:.0f}% reached)")
        say(f"{label}: library torch.cummax of both lanes min/median/max "
            f"{lib[0]:.4f} / {lib[1]:.4f} / {lib[2]:.4f} ms")


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


def cli_scan(label, argv, dst, dev=None, stdin_path=None, stats=None,
             engine=None):
    """One scan into the file `dst`: the port on `dev` with `engine` (None:
    the port's default, tpu), or `run_host` when `dev` is None; with
    `stdin_path` that file is piped to stdin. Returns (size, sha256) and
    appends (wall s, peak device bytes) to `stats`."""
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
            rc = run(parse_args(argv), out=out, device=dev, engine=engine)
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
    from stringsext_tpu_torch.ops import device_events, swar

    src = os.path.join(tmp, "buffered.bin")
    make_corpus(BUFFERED_SIZE, seed=0).tofile(src)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE", src]
    what = f"main path, {BUFFERED_SIZE // MIB} MiB trio"
    swar.swar_counts.launches = 0
    device_events._report_clamp.launches = 0
    port = cli_scan(f"{what}, port on the card", argv,
                    os.path.join(tmp, "port.out"), dev)
    count_launches(f"cli flagship scan, {BUFFERED_SIZE // MIB} MiB",
                   {"swar_counts": swar.swar_counts,
                    "report_clamp": device_events._report_clamp})
    launches = swar.swar_counts.launches
    clamps = device_events._report_clamp.launches
    host = cli_scan(f"{what}, port host path (whole stream, no hot map)",
                    argv, os.path.join(tmp, "host.out"))
    if port != host:
        raise AssertionError(f"port output differs from run_host's: "
                             f"{port} != {host}")
    if launches <= 0 or clamps <= 0:
        raise AssertionError(f"the main path launched swar_counts {launches} "
                             f"and the report clamp {clamps} times")
    say(f"phase 3: outputs byte-identical; swar_counts launches {launches}, "
        f"report clamp launches {clamps}")
    return src, host


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


class env_set:
    """Environment variables set (value None: removed) inside the block."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *_exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def feed_env(value):
    """STRINGSEXT_RUNTABLE_FEED set to `value` inside the block."""
    return env_set(STRINGSEXT_RUNTABLE_FEED=value)


def stateful_scans(dev, tmp, dst):
    """Phase 7b: the stateful set over `stateful_corpus`, streamed and
    buffered, feed on and off, in three turns with `run_host`; then the
    256 MiB streamed scan, feed on."""
    from stringsext_tpu_torch.corpus import STATEFUL_ENCODINGS, stateful_corpus
    from stringsext_tpu_torch.ops import (
        classify_cjk,
        classify_iso2022,
        device_events,
        swar,
    )
    from stringsext_tpu_torch.run import STREAM_CHUNK

    ssrc = os.path.join(tmp, "stateful.bin")
    stateful_corpus(STATEFUL_SIZE, seed=0).tofile(ssrc)
    sargv = ["-t", "x", "-u", "Asian"] + [a for e in STATEFUL_ENCODINGS
                                         for a in ("-e", e)]
    swhat = f"{STATEFUL_SIZE // MIB} MiB {'+'.join(STATEFUL_ENCODINGS)}"
    kernels = {"swar_counts": swar.swar_counts,
               "orbit_resolve": classify_cjk._orbit_mask_blocked,
               "report_clamp": device_events._report_clamp,
               "last_set_scan": classify_iso2022._scan_last_sets}
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
            feed = ("orbit_resolve", "report_clamp", "last_set_scan")
            need = feed if route.endswith("on") else ("swar_counts",)
            if not all(n[k] for k in need):
                raise AssertionError(f"7b {route}: {need} never ran ({n})")
            if route.endswith("off") and any(n[k] for k in feed):
                raise AssertionError(f"7b {route}: the feed's kernels ran "
                                     f"without the feed ({n})")
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
    """Phase 8: a buffered stream of 2 GiB or more, feed on. Returns the
    two files (phase 10 scans them again, then removes them), run_host's
    (size, sha256) and the walls {route: s}."""
    from stringsext_tpu_torch.corpus import sparse_corpus

    files = []
    for k in range(2):
        files.append(os.path.join(tmp, f"two-{k}.bin"))
        sparse_corpus(TWO_FILE_SIZE).tofile(files[-1])
    argv = ["-t", "x", "-e", "UTF-8"] + files
    dst = os.path.join(tmp, "two.out")
    what = f"8 two files of {TWO_FILE_SIZE} bytes, -e UTF-8, buffered"
    walls = {"port": [], "run_host": []}
    with feed_env("1"):
        port = cli_scan(f"{what}, port on the card, feed on", argv, dst, dev,
                        stats=walls["port"])
    host = cli_scan(f"{what}, run_host", argv, dst, stats=walls["run_host"])
    if port != host or port[0] < 100:
        raise AssertionError(f"8: {port} != {host}")
    say(f"phase 8: the {2 * TWO_FILE_SIZE}-byte buffered scan is "
        f"byte-identical to run_host")
    return files, host, {k: v[0][0] for k, v in walls.items()}


# ------------------------------------------------------------ phase 9: mesh


class mesh_devices_as:
    """`run.mesh_devices` answering `devices` inside the block: with
    `[dev] * 4` the CLI's hot map shards over a virtual mesh on one card,
    with `[dev]` it does not shard."""

    def __init__(self, devices):
        self.devices = devices

    def __enter__(self):
        from stringsext_tpu_torch import run

        self.saved = run.mesh_devices
        run.mesh_devices = lambda _device: self.devices

    def __exit__(self, *_exc):
        from stringsext_tpu_torch import run

        run.mesh_devices = self.saved


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_counts(dev, flagship, cards):
    """9a: `swar_counts` sharded over virtual meshes of 4 and 8 shards on
    the card, against one pass over the whole 128 MiB; then, on a host
    with several cards, over 1..N real cards (weak scaling)."""
    from stringsext_tpu_torch.corpus import flagship_missions, make_corpus
    from stringsext_tpu_torch.ops import swar
    from stringsext_tpu_torch.ops.specs import swar_mission_spec
    from stringsext_tpu_torch.parallel.mesh import (
        build_sharded_counts,
        make_mesh,
    )

    specs = tuple(swar_mission_spec(m) for m in flagship_missions().v[:3])
    words = words_of(flagship, dev)
    rows = words.shape[0]
    one = {h: swar.swar_counts(words, specs, hot_only=h) for h in (True, False)}
    one_ms = cuda_ms(lambda: swar.swar_counts(words, specs, hot_only=True),
                     reps=10, inner=1)
    readings = {}
    for n in (4, 8):
        fns = {}
        for hot_only in (True, False):
            fn = fns[hot_only] = build_sharded_counts(
                specs, make_mesh(n, 1, [dev] * n), rows // n,
                hot_only=hot_only)
            swar.swar_counts.launches = 0
            got = fn(words)
            launches = swar.swar_counts.launches
            count_launches(f"mesh counts, {n} shards of "
                           f"{len(flagship) // n // MIB} MiB (hot_only and "
                           f"with run bounds)",
                           {"swar_counts": swar.swar_counts})
            if launches != n:
                raise AssertionError(f"9a: {n} shards launched swar_counts "
                                     f"{launches} times")
            if not torch.equal(got.transpose(0, 1).reshape(one[hot_only].shape),
                               one[hot_only]):
                raise AssertionError(f"9a: {n} shards, hot_only={hot_only}: "
                                     f"counts differ from one pass")
        ms = readings[n] = cuda_ms(lambda: fns[True](words), reps=10,
                                   inner=1)
        say(f"9a {len(flagship) // MIB} MiB trio, {n} shards on one card: "
            f"bit-exact to one pass (hot_only and not), one launch a shard; "
            f"hot_only pass min/median/max {ms[0]:.4f} / {ms[1]:.4f} / "
            f"{ms[2]:.4f} ms against one pass {one_ms[0]:.4f} / "
            f"{one_ms[1]:.4f} / {one_ms[2]:.4f} ms on {card_line()}")
    del words, one

    if len(cards) < 2:
        say(f"9a weak scaling: the host has {len(cards)} card; no rows (the "
            f"shapes and equality above only)")
    else:
        weak_scaling(cards, specs, len(flagship))
    return {"one pass": one_ms, "4 shards": readings[4]}


def weak_scaling(cards, specs, per_card):
    """`swar_counts` sharded over the first k of `cards`, k = 1..N, with
    `per_card` bytes a card: the wall of one pass (the stream on the first
    card, its shards copied out, the count panels back), median of 10."""
    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.ops import swar
    from stringsext_tpu_torch.parallel.mesh import (
        build_sharded_counts,
        make_mesh,
    )

    raw = make_corpus(per_card * len(cards), seed=0)
    base = None
    for k in range(1, len(cards) + 1):
        w = words_of(raw[:per_card * k], cards[0])
        fn = build_sharded_counts(specs, make_mesh(k, 1, cards[:k]),
                                  w.shape[0] // k, hot_only=True)
        want = swar.swar_counts(w, specs, hot_only=True)
        got = fn(w)
        if not torch.equal(got.transpose(0, 1).reshape(want.shape), want):
            raise AssertionError(f"9a: {k} cards differ from one pass")
        walls = []
        for _ in range(12):
            sync_all()
            t0 = time.perf_counter()
            fn(w)
            sync_all()
            walls.append(time.perf_counter() - t0)
        walls = sorted(walls[2:])
        rate = per_card * k / walls[len(walls) // 2] / 1e9
        base = base or rate
        say(f"9a weak scaling, {k} card(s) x {per_card // MIB} MiB: wall "
            f"min / median / max {1e3 * walls[0]:.3f} / "
            f"{1e3 * walls[len(walls) // 2]:.3f} / {1e3 * walls[-1]:.3f} ms, "
            f"{rate:.2f} GB/s, {100 * rate / (k * base):.1f}% of {k} x one "
            f"card's rate; {card_line()}")
        del w, got, want


def mesh_scan(dev, tmp, stateful, cards=None):
    """9b: the all-kinds set on a 4 x 4 mesh over the stateful corpus
    against the single-device scan and, through the emitter, against
    run_host. Data row d runs on cards[d % len(cards)] (default: all on
    `dev`, a virtual mesh). Returns the single-device runs (stitched), the
    table capacity, the timed run's wall and peak device memory."""
    import numpy as np

    from stringsext_tpu_torch import native
    from stringsext_tpu_torch.cli import parse_args
    from stringsext_tpu_torch.entry import (
        _mesh_rows,
        _stitch,
        single_device_runs,
    )
    from stringsext_tpu_torch.input import load_stream, slice_table
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops import classify_cjk, classify_iso2022
    from stringsext_tpu_torch.parallel import mesh
    from stringsext_tpu_torch.run import _merge_ranges, run_host, write_output

    src = os.path.join(tmp, "mesh-stateful.bin")
    stateful.tofile(src)
    encs = ["Shift_JIS", "gb18030", "ISO-2022-JP", "UTF-8"]
    argv = ["-t", "x"] + [a for e in encs for a in ("-e", e)] + [src]
    args = parse_args(argv)
    ms = Missions.from_args(args).v
    n_data = n_mission = 4
    shard_len = len(stateful) // n_data
    cards = cards or [dev]
    where = ("one card" if len(cards) == 1
             else f"{len(cards)} cards, data row d on card d % {len(cards)}")
    what = (f"9b {len(stateful) // MIB} MiB stateful corpus, "
            f"{'+'.join(encs)}, {n_data} x {n_mission} mesh on {where}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [single_device_runs(stateful, m, dev) for m in ms]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    # the table capacity: above the most runs any shard holds
    most = 0
    for runs in want:
        s = np.array([r[0] for r in runs], np.int64)
        e = np.array([r[1] for r in runs], np.int64)
        for d in range(n_data):
            most = max(most, int(np.count_nonzero(
                (s < (d + 1) * shard_len) & (e > d * shard_len))))
    capacity = -(-(most + 1024) // 4096) * 4096
    want = [_stitch(runs) for runs in want]

    grid = [cards[d % len(cards)] for d in range(n_data)
            for _m in range(n_mission)]
    scan = mesh.build_sharded_scan(
        ms, mesh.make_mesh(n_data, n_mission, grid), shard_len,
        capacity=capacity)
    data = torch.from_numpy(stateful).to(dev)

    # Run 1: the main path, its orbit launches counted from 0 and every
    # stage-C probe held to the multi-start torch resolve.
    probes = []
    plain_probes = mesh._entry_probes

    def checked(step, owned_end):
        got = plain_probes(step, owned_end)
        ref = classify_cjk._orbit_masks_block0(
            step, owned_end, mesh.LEFT_CTX + torch.arange(4))
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"9b: stage C's kernel probes differ from "
                                 f"_orbit_masks_block0 at cap {step.numel()}")
        probes.append(step.numel())
        return got

    traffic = []
    classify_cjk._orbit_mask_blocked.launches = 0
    classify_iso2022._scan_last_sets.launches = 0
    mesh._entry_probes = checked
    try:
        rt = scan(data, traffic=traffic)
    finally:
        mesh._entry_probes = plain_probes
    launches = classify_cjk._orbit_mask_blocked.launches
    if torch.cuda.current_device() != dev.index:
        raise AssertionError(f"9b: the scan left the current device at "
                             f"{torch.cuda.current_device()}")
    if not classify_iso2022._scan_last_sets.launches:
        raise AssertionError("9b: the ISO-2022-JP column never launched the "
                             "last-set scan")
    count_launches(f"mesh scan {n_data} x {n_mission} on {where}, "
                   f"stateful {len(stateful) // MIB} MiB",
                   {"orbit_resolve": classify_cjk._orbit_mask_blocked,
                    "last_set_scan": classify_iso2022._scan_last_sets})
    chains = 3 * n_data  # Shift_JIS, gb18030 and ISO-2022-JP columns
    if len(probes) != chains or launches != 5 * chains:
        raise AssertionError(f"9b: {len(probes)} probe sets checked, "
                             f"{launches} orbit launches (want {chains}, "
                             f"{5 * chains})")
    if bool(rt.overflow.any()):
        raise AssertionError(f"9b: a cell overflowed capacity {capacity}")
    for mi, m in enumerate(ms):
        got = _stitch(_mesh_rows(rt, mi))
        if got != want[mi]:
            raise AssertionError(f"9b: {m.encoding_name}: stitched mesh "
                                 f"tables differ from the single-device scan")

    # Run 2: timed, its peak device memory.
    sync_all()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rt2 = scan(data)
    sync_all()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(torch.equal(a, b) for a, b in zip(rt, rt2)):
        raise AssertionError("9b: a second run gave other tables")
    del data, rt2

    # The emitter, its hot ranges from the stitched mesh tables.
    stream = load_stream(args.inputs)
    sl = slice_table(stream)
    results = []
    for mi, m in enumerate(ms):
        runs = want[mi]
        hot = _merge_ranges(np.array([r[0] for r in runs], np.int64) - 8,
                            np.array([r[1] for r in runs], np.int64) + 8,
                            len(stream.data))
        res, sb = native.native_scan(m, stream.data, *sl, hot_ranges=hot)
        results.append((m, res, sb))
    buf = io.BytesIO()
    write_output(buf, args, results)
    host = io.BytesIO()
    assert run_host(args, out=host) == 0
    if buf.getvalue() != host.getvalue() or len(host.getvalue()) < 1000:
        raise AssertionError("9b: the emitter over the mesh's runs differs "
                             "from run_host")
    os.unlink(src)
    halo = sum(b for (s, _), (d, _), b in traffic if abs(s - d) == 1)
    say(f"{what}: stitched tables equal the single-device scan "
        f"({', '.join(str(len(w)) for w in want)} runs), emitter output "
        f"byte-identical to run_host ({len(host.getvalue())} bytes); "
        f"capacity {capacity} (most runs in a cell {most}); orbit launches "
        f"{launches} ({len(probes)} x 4 stage-C probes, each set equal to "
        f"_orbit_masks_block0, and {chains} orbits); {len(traffic)} "
        f"exchanges, {sum(b for *_, b in traffic)} bytes; mesh scan wall "
        f"{wall:.3f} s (the single-device lanes and run listing "
        f"{single_s:.3f} s), peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB) on {card_line()}")
    return {"encs": encs, "want": want, "capacity": capacity, "wall": wall,
            "peak": peak}


def mesh_cli(dev, tmp, flagship, cards):
    """9c: the --mesh CLI on a virtual mesh of 4 shards, feed off,
    buffered and streamed, in turns with the unsharded feed-off scan and
    run_host; with several `cards`, also the scan over them (the
    default of a host with several cards)."""
    import contextlib

    from stringsext_tpu_torch.ops import swar

    src = os.path.join(tmp, "mesh-flagship.bin")
    flagship.tofile(src)
    dst = os.path.join(tmp, "mesh.out")
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"]
    routes = ("run_host", "mesh buffered", "mesh streamed",
              "unsharded buffered", "unsharded streamed")
    shards = {"mesh": [dev] * 4, "unsharded": [dev]}
    if len(cards) > 1:
        routes += ("cards buffered", "cards streamed")
        shards["cards"] = cards
    what = f"9c {len(flagship) // MIB} MiB trio, feed off"
    outs, walls, peaks, seen = set(), {}, {}, {}
    with feed_env("0"):
        for turn in range(3):
            for route in routes:
                devs = shards.get(route.split()[0])
                streamed = route.endswith("streamed")
                swar.swar_counts.launches = 0
                stats = []
                with (mesh_devices_as(devs) if devs
                      else contextlib.nullcontext()):
                    outs.add(cli_scan(
                        f"{what}, turn {turn + 1}, {route}",
                        argv + (["--mesh"] if route.startswith("mesh")
                                else [])
                        + ([] if streamed else [src]), dst,
                        None if route == "run_host" else dev,
                        stdin_path=src if streamed else None, stats=stats))
                walls.setdefault(route, []).append(stats[0][0])
                peaks[route] = max(peaks.get(route, 0), stats[0][1])
                seen[route] = swar.swar_counts.launches
                if turn == 0 and route != "run_host":
                    count_launches(f"cli trio {route}, feed off, "
                                   f"{len(flagship) // MIB} MiB",
                                   {"swar_counts": swar.swar_counts})
    os.unlink(src)
    if len(outs) != 1:
        raise AssertionError(f"9c: outputs differ: {outs}")
    for mode in ("buffered", "streamed"):
        one = seen[f"unsharded {mode}"]
        if not one or any(seen[f"{k} {mode}"] != len(v) * one
                          for k, v in shards.items()):
            raise AssertionError(f"9c: launches {seen}")
    say(f"phase {what} on {card_line()}: all byte-identical to "
        f"run_host; wall s min / median / max of 3 in turns: "
        + "; ".join(f"{r} {mmm(walls[r])}" for r in routes)
        + "; peak device memory "
        + ", ".join(f"{r} {peaks[r]}" for r in routes[1:])
        + f" bytes; swar_counts launches in one scan {seen}")


def phase_mesh(dev, tmp, stateful):
    """Phase 9: the mesh (stringsext_tpu_torch/parallel/mesh.py). Returns
    9a's and 9b's readings, which phase 12 is held to."""
    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.entry import dryrun_multichip

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    flagship = make_corpus(MESH_SIZE, seed=0)
    nine = {"counts": mesh_counts(dev, flagship, cards),
            "scan": mesh_scan(dev, tmp, stateful)}
    if len(cards) > 1:
        mesh_scan(dev, tmp, stateful, cards)
    mesh_cli(dev, tmp, flagship, cards)
    dryrun_multichip(8, dev)  # prints its line; raises on a mismatch
    return nine


# ------------------------------------------------- phase 10: multi-process

DIST_DEVICE = "cuda"  # the ranks' --device (a rehearsal on the CPU sets "cpu")
DIST_TIMEOUT_S = 600  # a case's limit; its ranks are killed when it passes
DIST_LINE = re.compile(
    r"dist rank (\d+) of (\d+) device (\S+) shard (\d+)\.\.(\d+) bytes_read "
    r"(\d+) swar_counts launches (\d+) orbit launches (\d+) scan wall "
    r"([\d.]+) s peak device memory (\d+) bytes checkpoint chunks skipped "
    r"(\d+) of (\d+)")


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_round(cmds, outs, tmp, limit_s, env=None, crash=False):
    """Start `cmds` together, one a rank process (stdin closed; rank k's
    stdout to the file outs[k], or with None to one of its own; stderr to
    a file), and wait for them. Returns [(exit code, stdout bytes, stderr
    text)] in rank order, the stdout bytes empty where they went to
    outs[k]; every rank is killed when `limit_s` passes, and when one
    fails unless all are to stop at the crash hook."""
    procs, files = [], []
    try:
        for k, cmd in enumerate(cmds):
            out = outs[k] or os.path.join(tmp, f"rank{k}.stdout")
            err = os.path.join(tmp, f"rank{k}.stderr")
            files.append((open(out, "wb"), open(err, "wb"), out, err))
            procs.append(subprocess.Popen(
                cmd, stdin=subprocess.DEVNULL, stdout=files[-1][0],
                stderr=files[-1][1], cwd=REPO, env=env))
        deadline = time.monotonic() + limit_s
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or (not crash and any(p.poll() not in (None, 0)
                                          for p in procs))):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fo, fe, _o, _e in files:
            fo.close()
            fe.close()
    res = []
    for p, dst, (_fo, _fe, out, err) in zip(procs, outs, files):
        with open(err, encoding="utf-8", errors="replace") as f:
            text = f.read()
        so = b""
        if not dst:
            with open(out, "rb") as f:
                so = f.read()
        res.append((p.returncode, so, text))
    return res


def dist_round(tmp, argv, nprocs, dst, to_file, env, crash):
    """One try: `nprocs` rank processes of the CLI started together (see
    `rank_round`), rank 0's output to `dst`."""
    coord = f"127.0.0.1:{free_port()}"
    cmds = []
    for k in range(nprocs):
        cmds.append([sys.executable, "-m", "stringsext_tpu_torch", "--device",
                     DIST_DEVICE, "--dist-nprocs", str(nprocs), "--dist-rank",
                     str(k), "--dist-coord", coord, *argv])
        if to_file:
            cmds[-1][-1:-1] = ["-p", dst]
    outs = [dst if k == 0 and not to_file else None for k in range(nprocs)]
    return rank_round(cmds, outs, tmp, DIST_TIMEOUT_S,
                      dict(os.environ, STRINGSEXT_PROFILE="1", **env), crash)


def dist_scan(label, tmp, argv, nprocs, dst, to_file=False, env=None,
              crash=False):
    """`python -m stringsext_tpu_torch --device cuda --dist-nprocs N
    --dist-rank K --dist-coord 127.0.0.1:PORT ARGV` for K in 0..N-1, under
    STRINGSEXT_PROFILE=1. Rank 0's bytes go to `dst`, through its stdout
    or `-p dst`; the other ranks' stdout must stay empty. A try whose
    coordinator port was taken meanwhile runs again on a fresh port (up to
    three tries); any other failing rank fails the case. With `crash`
    every rank must stop with the checkpoint's simulated crash. Returns
    (wall s, [per-rank dict of its profile line])."""
    for _attempt in range(3):
        t0 = time.perf_counter()
        res = dist_round(tmp, argv, nprocs, dst, to_file, env or {}, crash)
        wall = time.perf_counter() - t0
        if not any("Address already in use" in e for _rc, _o, e in res):
            break
    for k, (rc, so, err) in enumerate(res):
        if crash:
            if rc == 0 or "simulated distributed crash" not in err:
                raise AssertionError(f"{label}: rank {k} did not stop at the "
                                     f"crash hook (exit {rc})\n{err[-2000:]}")
            continue
        if rc != 0:
            raise AssertionError(f"{label}: rank {k} exit code {rc}\n"
                                 f"{err[-3000:]}")
        if k and so:
            raise AssertionError(f"{label}: rank {k} wrote {len(so)} bytes "
                                 f"to stdout")
    if crash:
        return wall, []
    ranks = []
    for k, (_rc, _so, err) in enumerate(res):
        m = DIST_LINE.search(err)
        if m is None or int(m.group(1)) != k:
            raise AssertionError(f"{label}: rank {k} printed no profile "
                                 f"line\n{err[-2000:]}")
        g = m.groups()
        ranks.append({"device": g[2], "shard": (int(g[3]), int(g[4])),
                      "bytes_read": int(g[5]), "swar_counts": int(g[6]),
                      "orbit_resolve": int(g[7]), "scan_wall": float(g[8]),
                      "peak": int(g[9]), "ckpt": (int(g[10]), int(g[11]))})
    return wall, ranks


def check_ranks(label, ranks, total, nprocs, kernels=(), max_read=None,
                split=False):
    """The ranks' own readings: each on its card (rank k on card k % the
    card count), `kernels` launched by every rank with a non-empty shard,
    bytes read under `max_read` of `total`, and with `split` every shard
    non-empty."""
    cards = torch.cuda.device_count()
    for k, r in enumerate(ranks):
        if DIST_DEVICE == "cuda" and r["device"] != f"cuda:{k % cards}":
            raise AssertionError(f"{label}: rank {k} ran on {r['device']}")
        busy = r["shard"][1] > r["shard"][0]
        if split and not busy:
            raise AssertionError(f"{label}: rank {k} got an empty shard "
                                 f"{r['shard']}")
        for name in kernels:
            if busy and not r[name]:
                raise AssertionError(f"{label}: rank {k} never launched "
                                     f"{name} ({r})")
        if max_read is not None and r["bytes_read"] >= max_read * total:
            raise AssertionError(f"{label}: rank {k} read {r['bytes_read']} "
                                 f"of {total} bytes")
    if sum(r["shard"][1] - r["shard"][0] for r in ranks) != total:
        raise AssertionError(f"{label}: the shards do not cover the input: "
                             f"{[r['shard'] for r in ranks]}")
    for name in RESULTS:
        n = sum(r.get(name, 0) for r in ranks)
        if n:
            RESULTS[name]["launches"][f"dist {label}"] = n


def dist_case(label, tmp, argv, inputs, nprocs, want, single, env,
              to_file=False, **checks):
    """One multi-process scan under `env` held to `want` (run_host's
    (size, sha256)) and to `checks` (see check_ranks), printed with its
    wall beside the single-process scans' `single` {route: wall s}."""
    dst = os.path.join(tmp, "dist.out")
    wall, ranks = dist_scan(label, tmp, argv + inputs, nprocs, dst, to_file,
                            env)
    got = sha_of(dst)
    os.unlink(dst)
    if got != want:
        raise AssertionError(f"{label}: rank 0 wrote {got}, run_host {want}")
    total = sum(os.path.getsize(f) for f in inputs)
    check_ranks(label, ranks, total, nprocs, **checks)
    say(f"10 {label}: {nprocs} ranks, rank 0's {got[0]} bytes equal "
        f"run_host's; wall {wall:.3f} s (process start included); "
        + "; ".join(f"rank {k} on {r['device']}: shard {r['shard'][0]}.."
                    f"{r['shard'][1]}, bytes_read {r['bytes_read']}, "
                    f"swar_counts {r['swar_counts']}, orbit "
                    f"{r['orbit_resolve']}, scan wall {r['scan_wall']:.3f} s,"
                    f" peak {r['peak']} bytes"
                    for k, r in enumerate(ranks))
        + "; single process " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in single.items()))
    return wall, ranks


def single_scans(label, tmp, argv, dev, feeds):
    """run_host's (size, sha256) and the walls of it and of the
    single-process buffered scan on the card with the feed on and off."""
    dst = os.path.join(tmp, "single.out")
    walls = {}
    stats = []
    want = cli_scan(f"10 {label}, run_host", argv, dst, stats=stats)
    walls["run_host"] = stats[-1][0]
    for feed in feeds:
        with feed_env(feed):
            got = cli_scan(f"10 {label}, one process on the card, feed "
                           f"{'on' if feed == '1' else 'off'}", argv, dst,
                           dev, stats=stats)
        walls[f"buffered feed {'on' if feed == '1' else 'off'}"] = (
            stats[-1][0])
        if got != want:
            raise AssertionError(f"10 {label}: {got} != run_host's {want}")
    return want, walls


def phase_dist(dev, tmp, two_files, two_host, two_walls):
    """Phase 10: the multi-process scan (parallel/distributed.py), N rank
    processes over torch.distributed (gloo, the TCPStore at rank 0)."""
    from stringsext_tpu_torch.corpus import (STATEFUL_ENCODINGS, make_corpus,
                                             sparse_corpus, stateful_corpus)

    cards = torch.cuda.device_count()
    t_phase = time.perf_counter()
    flag = os.path.join(tmp, "dist-flagship.bin")
    make_corpus(MESH_SIZE, seed=0).tofile(flag)
    stat = os.path.join(tmp, "dist-stateful.bin")
    stateful_corpus(STATEFUL_SIZE, seed=0).tofile(stat)
    trio = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"]
    sargv = ["-t", "x", "-u", "Asian"] + [a for e in STATEFUL_ENCODINGS
                                         for a in ("-e", e)]
    off = {"STRINGSEXT_RUNTABLE_FEED": "0"}
    on = {"STRINGSEXT_RUNTABLE_FEED": "1"}

    # (a) the flagship trio, 128 MiB: over the bench corpus (random bytes,
    # hot everywhere: the boundary search finds no quiescent row and rank
    # 0 absorbs the input, as in the reference) feed off, and over the
    # sparse corpus (a real split) feed on through stdout and feed off
    # through -p; with several cards also one rank a card
    fa = f"a flagship {MESH_SIZE // MIB} MiB trio"
    want, single = single_scans(f"{fa}, bench corpus", tmp, trio + [flag],
                                dev, ("0",))
    _w, ranks = dist_case(f"{fa}, bench corpus, feed off", tmp, trio, [flag],
                          2, want, single, env=off, kernels=("swar_counts",))
    if ranks[1]["shard"][1] > ranks[1]["shard"][0]:
        raise AssertionError(f"10a: the bench corpus split: {ranks}")
    os.unlink(flag)
    sparse = os.path.join(tmp, "dist-sparse.bin")
    sparse_corpus(MESH_SIZE).tofile(sparse)
    pwant, psingle = single_scans(f"{fa}, sparse corpus", tmp,
                                  trio + [sparse], dev, ("1", "0"))
    dist_case(f"{fa}, sparse corpus, feed on", tmp, trio, [sparse], 2, pwant,
              psingle, env=on, max_read=0.75, split=True)
    dist_case(f"{fa}, sparse corpus, feed off, -p FILE", tmp, trio, [sparse],
              2, pwant, psingle, env=off, to_file=True,
              kernels=("swar_counts",), max_read=0.75, split=True)
    if cards > 1:
        dist_case(f"{fa}, sparse corpus, feed off, one rank a card", tmp,
                  trio, [sparse], cards, pwant, psingle, env=off,
                  kernels=("swar_counts",))

    # (b) the stateful set, 64 MiB: a real split, feed on and off
    fb = f"b stateful set {STATEFUL_SIZE // MIB} MiB"
    swant, ssingle = single_scans(fb, tmp, sargv + [stat], dev, ("1", "0"))
    dist_case(f"{fb}, feed on", tmp, sargv, [stat], 2, swant, ssingle,
              env=on, kernels=("orbit_resolve",), split=True)
    dist_case(f"{fb}, feed off", tmp, sargv, [stat], 2, swant, ssingle,
              env=off, kernels=("swar_counts",), split=True)
    if cards > 1:
        dist_case(f"{fb}, feed on, one rank a card", tmp, sargv, [stat],
                  cards, swant, ssingle, env=on, kernels=("orbit_resolve",))

    # (c) phase 8's two files of 1.1 GiB, -e UTF-8, feed on
    fc = f"c two files of {TWO_FILE_SIZE // MIB} MiB, -e UTF-8"
    dist_case(f"{fc}, feed on", tmp, ["-t", "x", "-e", "UTF-8"], two_files,
              2, two_host, {"buffered feed on": two_walls["port"],
                            "run_host": two_walls["run_host"]},
              env=on, max_read=0.75, split=True)
    for f in two_files:
        os.unlink(f)

    # (d) --checkpoint over the sparse corpus: both ranks stopped after two
    # chunks of 8 MiB, then the same command resumes to the uninterrupted
    # bytes
    ck = os.path.join(tmp, "dist.ck")
    cargv = trio + ["--checkpoint", ck]
    chunk = {"STRINGSEXT_DIST_CKPT_CHUNK": "2048", **off}
    dst = os.path.join(tmp, "dist.out")
    dist_scan("10d crash", tmp, cargv + [sparse], 2, dst,
              env=dict(chunk, STRINGSEXT_DIST_CKPT_DIE="2"), crash=True)
    left = sorted(p for p in os.listdir(tmp) if p.startswith("dist.ck.rank"))
    if not {"dist.ck.rank0", "dist.ck.rank1"} <= set(left):
        raise AssertionError(f"10d: the crash left {left}")
    _w, ranks = dist_case("d sparse flagship --checkpoint, resumed", tmp,
                          cargv, [sparse], 2, pwant, psingle, env=chunk,
                          split=True)
    skipped = [r["ckpt"] for r in ranks]
    if any(s < 1 or s >= t for s, t in skipped):
        raise AssertionError(f"10d: chunks skipped of all {skipped}")
    left = [p for p in os.listdir(tmp) if p.startswith("dist.ck")]
    if left:
        raise AssertionError(f"10d: the resumed scan left {left}")
    os.unlink(sparse)
    say(f"phase 10 on {card_line()}: every multi-process scan wrote "
        f"run_host's bytes (checkpoint chunks skipped of all {skipped}); "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------- phase 11: the engines

ENGINE_PYTHON_SIZE = 1 * MIB  # the python engine's input (about 2 s a MiB)


def probe_checks(cache):
    """11a: the link probe from an empty cache, from the cache, and over a
    document without the port's backend tag. Returns the measurement."""
    from stringsext_tpu_torch import run

    children = []
    measure = run._measure_device_link

    def counted():
        t0 = time.perf_counter()
        m = measure()
        children.append(time.perf_counter() - t0)
        return m

    run._measure_device_link = counted
    try:
        verdict = run._auto_engine()  # empty cache: the child measures
        with open(cache) as f:
            doc = json.load(f)
        if verdict != "tpu" or doc.get("backend") != "torch" or "error" in doc:
            raise AssertionError(f"11a: the probe gave {verdict!r}: {doc}")
        if doc["bw_bytes_s"] < 2e9 or doc["rt_lat_s"] > 0.05:
            raise AssertionError(f"11a: the link misses the thresholds: {doc}")
        t0 = time.perf_counter()
        again = run._auto_engine()  # from the cache: no child
        cached_s = time.perf_counter() - t0
        if again != "tpu" or len(children) != 1:
            raise AssertionError(f"11a: cached call gave {again!r} after "
                                 f"{len(children)} children")
        with open(cache, "w") as f:  # the reference's document: no tag
            json.dump({"verdict": "auto", "reason": "written by the JAX "
                       "package", "time": time.time()}, f)
        third = run._auto_engine()
        with open(cache) as f:
            redo = json.load(f)
        if third != "tpu" or len(children) != 2 or redo.get("backend") != (
                "torch"):
            raise AssertionError(f"11a: an untagged document was honoured: "
                                 f"{third!r}, {len(children)} children, "
                                 f"{redo}")
    finally:
        run._measure_device_link = measure
    say(f"11a probe on {card_line()}: bw {doc['bw_bytes_s'] / 1e9:.3f} GB/s "
        f"(8 MiB pageable host-to-device copy), lat "
        f"{doc['rt_lat_s'] * 1e3:.4f} ms (scalar round trip) on "
        f"{doc['device']}; verdict tpu; children {len(children)} "
        f"({', '.join(f'{c:.2f} s' for c in children)}), cached call "
        f"{cached_s * 1e3:.3f} ms; an untagged document re-measured "
        f"(bw {redo['bw_bytes_s'] / 1e9:.3f} GB/s, lat "
        f"{redo['rt_lat_s'] * 1e3:.4f} ms)")
    return doc


def host_scan(label, argv, dst, dev, engine, stdin_path=None, walls=None):
    """One scan of the port with `engine` that must launch no kernel and
    leave the card's peak memory where a reset put it. Returns (size,
    sha256)."""
    from stringsext_tpu_torch.ops import (
        classify_cjk,
        classify_iso2022,
        device_events,
        swar,
    )

    kernels = (swar.swar_counts, classify_cjk._orbit_mask_blocked,
               device_events._report_clamp, classify_iso2022._scan_last_sets)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    stats = []
    out = cli_scan(label, argv, dst, dev, stdin_path=stdin_path, stats=stats,
                   engine=engine)
    if any(fn.launches for fn in kernels) or stats[0][1] != base:
        raise AssertionError(f"{label}: launches "
                             f"{[fn.launches for fn in kernels]}, peak "
                             f"{stats[0][1]} against {base} bytes")
    if walls is not None:
        walls.append(stats[0][0])
    return out


def phase_engine(dev, tmp, stateful):
    """Phase 11: the engine choice (`--engine auto|tpu|python`)."""
    import contextlib

    from stringsext_tpu_torch import cli
    from stringsext_tpu_torch.corpus import (STATEFUL_ENCODINGS, make_corpus,
                                             sparse_corpus)
    from stringsext_tpu_torch.ops import swar

    t_phase = time.perf_counter()
    cache = os.path.join(tmp, "probe.json")
    with env_set(STRINGSEXT_PROBE_CACHE=cache, STRINGSEXT_DEVICE_PROBE=None):
        probe_checks(cache)

        src = os.path.join(tmp, "engine.bin")
        make_corpus(BUFFERED_SIZE, seed=0).tofile(src)
        trio = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"]
        dst = os.path.join(tmp, "engine.out")
        what = f"{BUFFERED_SIZE // MIB} MiB trio"
        want = cli_scan(f"11 {what}, run_host", trio + [src], dst)

        # (b) the CLI child asks the probe, which answers from the cache
        got, n, _peak, _hot, err = cli_child(
            f"11b {what}, CLI --engine auto", ["--engine", "auto"] + trio
            + [src], dst)
        line = next((ln for ln in err.splitlines()
                     if ln.startswith("engine auto -> ")), "")
        if got != want or not line.startswith("engine auto -> tpu (cached")\
                or n <= 0:
            raise AssertionError(f"11b: {got} != {want}, verdict line "
                                 f"{line!r}, swar_counts launches {n}")
        RESULTS["swar_counts"]["launches"][
            f"cli --engine auto (tpu verdict), {what} (child process)"] = n
        say(f"11b: {line}; swar_counts launches {n}")

    # (c) buffered in turns, then streamed from a pipe, the probe pinned
    # off for the auto routes (the host route)
    walls = {"tpu": [], "auto": [], "auto --host-hotmap": [], "run_host": []}
    for turn in range(3):
        for route in walls:
            label = f"11c turn {turn + 1}, {what}, buffered {route}"
            if route == "run_host":
                stats = []
                got = cli_scan(label, trio + [src], dst, stats=stats)
                walls[route].append(stats[0][0])
            elif route == "tpu":
                swar.swar_counts.launches = 0
                stats = []
                got = cli_scan(label, trio + [src], dst, dev, stats=stats,
                               engine="tpu")
                walls[route].append(stats[0][0])
                if not swar.swar_counts.launches:
                    raise AssertionError(f"{label}: swar_counts never ran")
                if turn == 0:
                    count_launches(f"cli --engine tpu buffered, {what}",
                                   {"swar_counts": swar.swar_counts})
            else:
                flags = ["--host-hotmap"] if "hotmap" in route else []
                with env_set(STRINGSEXT_DEVICE_PROBE="0"):
                    got = host_scan(label, flags + trio + [src], dst, dev,
                                    "auto", walls=walls[route])
            if got != want:
                raise AssertionError(f"{label}: {got} != run_host's {want}")
    streamed = {}
    for route in ("tpu", "auto", "auto --host-hotmap"):
        label = f"11c {what}, streamed from a pipe, {route}"
        stats = []
        if route == "tpu":
            got = cli_scan(label, trio, dst, dev, stdin_path=src, stats=stats,
                           engine="tpu")
            streamed[route] = stats[0][0]
        else:
            flags = ["--host-hotmap"] if "hotmap" in route else []
            w = []
            with env_set(STRINGSEXT_DEVICE_PROBE="0"):
                got = host_scan(label, flags + trio, dst, dev, "auto",
                                stdin_path=src, walls=w)
            streamed[route] = w[0]
        if got != want:
            raise AssertionError(f"{label}: {got} != run_host's {want}")

    # (d) the stateful set over the stateful corpus, the host route
    ssrc = os.path.join(tmp, "engine-stateful.bin")
    stateful.tofile(ssrc)
    sargv = ["-t", "x", "-u", "Asian"] + [a for e in STATEFUL_ENCODINGS
                                         for a in ("-e", e)]
    swhat = f"{len(stateful) // MIB} MiB stateful set"
    swant = cli_scan(f"11d {swhat}, run_host", sargv + [ssrc], dst)
    swalls = {}
    with env_set(STRINGSEXT_DEVICE_PROBE="0"):
        for flags in (["--host-hotmap"], []):
            route = " ".join(["auto"] + flags)
            w = []
            got = host_scan(f"11d {swhat}, buffered {route}",
                            flags + sargv + [ssrc], dst, dev, "auto", walls=w)
            swalls[route] = w[0]
            if got != swant:
                raise AssertionError(f"11d {route}: {got} != {swant}")
    os.unlink(ssrc)

    # (e) the python engine on 1 MiB, and its refusal of --checkpoint
    small = os.path.join(tmp, "engine-small.bin")
    make_corpus(ENGINE_PYTHON_SIZE, seed=0).tofile(small)
    pwant = cli_scan(f"11e {ENGINE_PYTHON_SIZE // MIB} MiB trio, run_host",
                     trio + [small], dst)
    w = []
    got = host_scan(f"11e {ENGINE_PYTHON_SIZE // MIB} MiB trio, --engine "
                    f"python", trio + [small], dst, dev, "python", walls=w)
    if got != pwant:
        raise AssertionError(f"11e python: {got} != {pwant}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--engine", "python", "--checkpoint",
                       os.path.join(tmp, "python.ck"), "-p", dst, small])
    if rc != 1 or "--checkpoint requires the native engine (engine=auto or "\
            "tpu)" not in err.getvalue():
        raise AssertionError(f"11e: --engine python --checkpoint gave {rc}: "
                             f"{err.getvalue()!r}")
    os.unlink(small)

    # (f) two rank processes on the host route with the numpy hot map
    sparse = os.path.join(tmp, "engine-sparse.bin")
    sparse_corpus(MESH_SIZE).tofile(sparse)
    dwant = cli_scan(f"11f {MESH_SIZE // MIB} MiB sparse trio, run_host",
                     trio + [sparse], dst)
    dist_wall, ranks = dist_scan(
        "11f ranks --engine auto --host-hotmap", tmp,
        ["--engine", "auto", "--host-hotmap"] + trio + [sparse], 2, dst,
        env={"STRINGSEXT_DEVICE_PROBE": "0"})
    got = sha_of(dst)
    if got != dwant:
        raise AssertionError(f"11f: rank 0 wrote {got}, run_host {dwant}")
    for k, r in enumerate(ranks):
        if (r["device"] != "host" or r["swar_counts"] or r["orbit_resolve"]
                or r["peak"] or r["shard"][1] <= r["shard"][0]):
            raise AssertionError(f"11f: rank {k} {r}")
    os.unlink(sparse)
    os.unlink(src)
    say(f"phase 11 on {card_line()}: every engine wrote run_host's bytes; "
        f"{what}, wall s min / median / max of 3 in turns, buffered: "
        + "; ".join(f"{r} {mmm(walls[r])}" for r in walls)
        + "; streamed from a pipe: "
        + ", ".join(f"{r} {v:.3f}" for r, v in streamed.items())
        + f"; {swhat}: " + ", ".join(f"{r} {v:.3f}" for r, v in swalls.items())
        + f" (run_host above); python {ENGINE_PYTHON_SIZE // MIB} MiB "
        f"{w[0]:.3f}; two ranks on the host route {dist_wall:.3f} (process "
        f"start included), shards "
        + ", ".join(f"{r['shard'][0]}..{r['shard'][1]}" for r in ranks)
        + f"; phase wall {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------- phase 12: the process mesh

PMESH_RANKS = 2  # rank k on card k % the card count (both on cuda:0 with one)
PMESH_COUNT_ROWS = 4  # data rows a rank holds of the sharded counts
PMESH_SCAN_ROWS = 2  # and of the 4 x 4 sharded scan
PMESH_TIMEOUT_S = 150  # the phase's limit; its ranks are killed when it passes
BLOCKED = ("jax", "jaxlib", "stringsext_tpu", "bench", "__graft_entry__")


def check_jax_free():
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    if loaded:
        raise AssertionError(f"imported {loaded}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pmesh_rank(nprocs, rank, coord, work, device):
    """One rank of phase 12, started by `phase_process_mesh` as `python3
    chip_smoke.py --pmesh-rank NPROCS RANK COORD WORK DEVICE`: it joins
    the gloo group at COORD (`distributed.initialize`), reads only its
    rows' bytes of the files in WORK (`distributed.host_shard_range`),
    runs the sharded counts (hot_only on and off) and the sharded scan on
    a process mesh on its card, holds its counts to the one pass in WORK,
    leaves its run tables there as `tables{RANK}.npz` and prints one line
    `PMESH {json}` of its launches, exchanges, walls and peak memory."""
    import numpy as np

    from stringsext_tpu_torch.cli import parse_args
    from stringsext_tpu_torch.corpus import flagship_missions
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.ops import classify_cjk, swar
    from stringsext_tpu_torch.ops.specs import swar_mission_spec
    from stringsext_tpu_torch.parallel import distributed, mesh

    nprocs, rank = int(nprocs), int(rank)
    distributed.initialize(coord, nprocs, rank)
    dev = distributed.rank_device(device, rank)
    with open(os.path.join(work, "pmesh.json")) as f:
        job = json.load(f)
    rep = {"rank": rank, "device": str(dev)}

    def crossed(traffic):
        return sum(t[2] for t in traffic if len(t) == 4)

    def rows_of(path, shard):
        lo, hi = distributed.host_shard_range(os.path.getsize(path), shard)
        raw = np.fromfile(path, np.uint8, count=hi - lo, offset=lo)
        return lo // shard, hi // shard, torch.from_numpy(raw).to(dev)

    # (a) the counts over PMESH_COUNT_ROWS rows a rank
    specs = tuple(swar_mission_spec(m) for m in flagship_missions().v[:3])
    flag = os.path.join(work, "flagship.bin")
    shard = os.path.getsize(flag) // (nprocs * PMESH_COUNT_ROWS)
    pm = mesh.make_process_mesh(1, [dev] * PMESH_COUNT_ROWS)
    lo, hi, raw = rows_of(flag, shard)
    if range(lo, hi) != pm.rows:
        raise AssertionError(f"rank {rank}: host_shard_range rows {lo}..{hi}"
                             f" are not the mesh's {pm.rows}")
    words = raw.view(torch.int32).reshape(-1, 128)
    fns = {}
    for hot_only in (True, False):
        fn = fns[hot_only] = mesh.build_sharded_counts(
            specs, pm, shard // 512, hot_only=hot_only)
        traffic = []
        swar.swar_counts.launches = 0
        got = fn(words, traffic)
        launches = swar.swar_counts.launches
        want = np.load(os.path.join(work, f"one_{hot_only}.npy"),
                       mmap_mode="r")
        want = want[:, lo * shard // 512:hi * shard // 512]
        if not np.array_equal(got.transpose(0, 1).reshape(want.shape).cpu()
                              .numpy(), want):
            raise AssertionError(f"rank {rank}: counts (hot_only="
                                 f"{hot_only}) differ from one pass")
        rep[f"counts hot_only={hot_only}"] = {
            "swar_counts": launches, "crossed": crossed(traffic),
            "exchanges": len(traffic)}
    walls = []
    for _ in range(5):
        sync(dev)
        t0 = time.perf_counter()
        fns[True](words)
        sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    rep["counts ms"] = sorted(walls)
    del words, raw

    # (b) the scan: PMESH_SCAN_ROWS rows a rank of a 4 x 4 mesh
    stat = os.path.join(work, "stateful.bin")
    encs = job["encs"]
    ms = Missions.from_args(parse_args(
        ["-t", "x"] + [a for e in encs for a in ("-e", e)] + [stat])).v
    shard = os.path.getsize(stat) // (nprocs * PMESH_SCAN_ROWS)
    pm = mesh.make_process_mesh(len(encs), [dev] * (PMESH_SCAN_ROWS
                                                    * len(encs)))
    lo, hi, data = rows_of(stat, shard)
    if range(lo, hi) != pm.rows:
        raise AssertionError(f"rank {rank}: scan rows {lo}..{hi}, mesh "
                             f"{pm.rows}")
    scan = mesh.build_sharded_scan(ms, pm, shard, capacity=job["capacity"])
    traffic = []
    classify_cjk._orbit_mask_blocked.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    rt = scan(data, traffic)
    sync(dev)
    rep["scan"] = {
        "wall": time.perf_counter() - t0,
        "peak": (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else 0),
        "orbit_resolve": classify_cjk._orbit_mask_blocked.launches,
        "crossed": crossed(traffic), "exchanges": len(traffic),
        "rows": [pm.rows.start, pm.rows.stop]}
    np.savez(os.path.join(work, f"tables{rank}.npz"),
             **{f: getattr(rt, f).cpu().numpy() for f in rt._fields})
    distributed.shutdown()
    check_jax_free()
    say("PMESH " + json.dumps(rep))
    return 0


def phase_process_mesh(dev, tmp, stateful, nine):
    """Phase 12: the mesh across processes (`mesh.make_process_mesh`),
    PMESH_RANKS rank processes of `pmesh_rank` started together, held to
    phase 9's one-process readings `nine`."""
    import numpy as np

    from stringsext_tpu_torch.corpus import flagship_missions, make_corpus
    from stringsext_tpu_torch.entry import _mesh_rows, _stitch
    from stringsext_tpu_torch.ops import swar
    from stringsext_tpu_torch.ops.runs import RunTable
    from stringsext_tpu_torch.ops.specs import swar_mission_spec

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "pmesh")
    os.makedirs(work)
    flagship = make_corpus(MESH_SIZE, seed=0)
    flagship.tofile(os.path.join(work, "flagship.bin"))
    specs = tuple(swar_mission_spec(m) for m in flagship_missions().v[:3])
    words = words_of(flagship, dev)
    for hot_only in (True, False):
        np.save(os.path.join(work, f"one_{hot_only}.npy"),
                swar.swar_counts(words, specs, hot_only=hot_only).cpu()
                .numpy())
    del words, flagship
    stateful.tofile(os.path.join(work, "stateful.bin"))
    nine_scan = nine["scan"]
    with open(os.path.join(work, "pmesh.json"), "w") as f:
        json.dump({"encs": nine_scan["encs"],
                   "capacity": nine_scan["capacity"]}, f)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card

    for _attempt in range(3):
        coord = f"127.0.0.1:{free_port()}"
        cmds = [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--pmesh-rank", str(PMESH_RANKS), str(k), coord, work,
                 DIST_DEVICE] for k in range(PMESH_RANKS)]
        t0 = time.perf_counter()
        res = rank_round(cmds, [None] * PMESH_RANKS, work, PMESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if not any("Address already in use" in e for _rc, _o, e in res):
            break
    failed = sorted(((rc < 0, k, rc, err) for k, (rc, _so, err)
                     in enumerate(res) if rc != 0))  # killed ranks last
    if failed:
        raise AssertionError(
            f"12: after {wall:.1f} s (limit {PMESH_TIMEOUT_S} s) "
            + ", ".join(f"rank {k} exit code {rc}" for _, k, rc, _e in failed)
            + f"; rank {failed[0][1]}:\n{failed[0][3][-3000:]}")
    reps = []
    for _rc, so, _err in res:
        line = [x for x in so.decode().splitlines() if x.startswith("PMESH ")]
        reps.append(json.loads(line[-1][len("PMESH "):]))

    halo = 8 * 512  # HALO_ROWS word rows
    chains = 3  # Shift_JIS, gb18030 and ISO-2022-JP columns
    for k, r in enumerate(reps):
        ends = (k > 0) + (k < PMESH_RANKS - 1)
        for hot_only in (True, False):
            c = r[f"counts hot_only={hot_only}"]
            if c["crossed"] != 2 * halo * ends or (
                    DIST_DEVICE == "cuda"
                    and c["swar_counts"] != PMESH_COUNT_ROWS):
                raise AssertionError(f"12a: rank {k} {c}")
        if DIST_DEVICE == "cuda" and (
                r["scan"]["orbit_resolve"] != 5 * chains * PMESH_SCAN_ROWS):
            raise AssertionError(f"12b: rank {k} {r['scan']}")
        counts = sum(r[f"counts hot_only={h}"]["swar_counts"]
                     for h in (True, False))
        for name, n in (("swar_counts", counts),
                        ("orbit_resolve", r["scan"]["orbit_resolve"])):
            RESULTS[name]["launches"][f"process mesh, rank {k} of "
                                      f"{PMESH_RANKS}"] = n

    tabs = [np.load(os.path.join(work, f"tables{k}.npz"))
            for k in range(PMESH_RANKS)]
    rt = RunTable(*(torch.from_numpy(np.concatenate([t[f] for t in tabs]))
                    for f in RunTable._fields))
    if bool(rt.overflow.any()):
        raise AssertionError("12b: a cell overflowed")
    for mi, enc in enumerate(nine_scan["encs"]):
        if _stitch(_mesh_rows(rt, mi)) != nine_scan["want"][mi]:
            raise AssertionError(f"12b: {enc}: the ranks' stitched tables "
                                 f"differ from the single-device scan")
    shutil.rmtree(work)
    one = nine["counts"]["4 shards"]
    say(f"12a {MESH_SIZE // MIB} MiB trio, sharded counts over "
        f"{PMESH_RANKS} ranks x {PMESH_COUNT_ROWS} rows of "
        f"{MESH_SIZE // PMESH_RANKS // PMESH_COUNT_ROWS // MIB} MiB: each "
        f"rank's rows bit-exact to one pass (hot_only and not), "
        f"{PMESH_COUNT_ROWS} swar_counts launches a rank a call; "
        + "; ".join(
            f"rank {r['rank']} on {r['device']}: crossed ranks "
            f"{r['counts hot_only=True']['crossed']} bytes a call, hot_only "
            f"pass wall min / median / max of 5 "
            f"{r['counts ms'][0]:.3f} / {r['counts ms'][2]:.3f} / "
            f"{r['counts ms'][4]:.3f} ms" for r in reps)
        + f" (phase 9a, 4 shards in one process: {one[1]:.4f} ms by CUDA "
        f"events)")
    say(f"12b {len(stateful) // MIB} MiB stateful corpus, "
        f"{'+'.join(nine_scan['encs'])}, 4 x 4 mesh, {PMESH_SCAN_ROWS} rows "
        f"a rank: the ranks' stitched tables equal the single-device scan's; "
        + "; ".join(
            f"rank {r['rank']} on {r['device']}: orbit launches "
            f"{r['scan']['orbit_resolve']}, crossed ranks "
            f"{r['scan']['crossed']} bytes in {r['scan']['exchanges']} "
            f"exchanges, scan wall {r['scan']['wall']:.3f} s, peak device "
            f"memory {r['scan']['peak']} bytes "
            f"({r['scan']['peak'] / 2**30:.2f} GiB)" for r in reps)
        + f" (phase 9b in one process: {nine_scan['wall']:.3f} s, peak "
        f"{nine_scan['peak']} bytes)")
    say(f"phase 12 on {card_line()}: ranks' round {wall:.1f} s (process "
        f"start included), phase wall {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------ phase 13: the installed port

FUZZ_TRIALS = 100  # 13c: the fuzzer's trials on the card (about 25 s)
INSTALLED_TIMEOUT_S = 600  # each child's limit in phase 13
CONSOLE_SCRIPT = """#!{python}
# -*- coding: utf-8 -*-
import re
import sys
from stringsext_tpu_torch.cli import main
if __name__ == '__main__':
    sys.argv[0] = re.sub(r'(-script\\.pyw|\\.exe)?$', '', sys.argv[0])
    sys.exit(main())
"""


def tree_of(path):
    """(relative path, size, mtime) of everything under `path`."""
    out = []
    for root, dirs, names in os.walk(path):
        for n in dirs + names:
            st = os.stat(os.path.join(root, n))
            out.append((os.path.relpath(os.path.join(root, n), path),
                        st.st_size, st.st_mtime_ns))
    return sorted(out)


def child_json(label, cmd, cwd, env):
    """Run `cmd`; it must exit 0 and print one JSON object last. Returns
    (that object, wall seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, env=env,
                       timeout=INSTALLED_TIMEOUT_S, stdin=subprocess.DEVNULL)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{label}: exit code {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    line = r.stdout.strip().splitlines()[-1]
    say(f"{label} ({wall:.1f} s): {line}")
    return json.loads(line), wall


def phase_installed(tmp, main_src, main_host):
    """Phase 13: the port as an install lays it out, its console script,
    scripts/cuda_smoke.py through that script, scripts/fuzz_torch.py on
    the card, and (13d) the port's .deb."""
    import glob

    t_phase = time.perf_counter()
    site, home, bindir, work = (os.path.join(tmp, d) for d in
                                ("site", "home", "bin", "work"))
    for d in (home, bindir, work):
        os.makedirs(d)
    shutil.copytree(os.path.join(REPO, "stringsext_tpu_torch"),
                    os.path.join(site, "stringsext_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    script = os.path.join(bindir, "stringsext-tpu-torch")
    with open(script, "w") as f:
        f.write(CONSOLE_SCRIPT.format(python=sys.executable))
    os.chmod(script, 0o755)
    env = dict(os.environ, HOME=home, PYTHONPATH=site,
               PYTHONDONTWRITEBYTECODE="1")
    cache = os.path.join(home, ".cache", "stringsext-tpu-torch", "kernels")

    # (a) the console script from outside the checkout, into a fresh cache
    before = tree_of(site)
    dst = os.path.join(tmp, "installed.out")
    argv = ["--device", "cuda", "-t", "x", "-e", "UTF-8", "-e", "UTF-16LE",
            "-e", "UTF-16BE", "-p", dst, main_src]
    t0 = time.perf_counter()
    r = subprocess.run([script, *argv], capture_output=True, text=True,
                       cwd=work, env=dict(env, STRINGSEXT_PROFILE="1"),
                       timeout=INSTALLED_TIMEOUT_S, stdin=subprocess.DEVNULL)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"13a: exit code {r.returncode}\n"
                             f"{r.stderr[-3000:]}")
    got = sha_of(dst)
    if got != main_host:
        raise AssertionError(f"13a: the installed CLI's bytes {got} differ "
                             f"from run_host's {main_host}")
    kern = re.search(r"^torch kernels: (.+) \(built in ([0-9.]+) s\)$",
                     r.stderr, re.M)
    emit = re.search(r"^native emitter: (.+) \(built in ([0-9.]+) s\)$",
                     r.stderr, re.M)
    libs = (glob.glob(os.path.join(cache, "libstringsext_kernels_*.so")),
            glob.glob(os.path.join(cache, "libemitter-*.so")))
    if not (kern and emit) or [len(x) for x in libs] != [1, 1] or \
            (kern.group(1), emit.group(1)) != (libs[0][0], libs[1][0]):
        raise AssertionError(f"13a: the libraries were not built into "
                             f"{cache}: {libs}\n{r.stderr[-3000:]}")
    if tree_of(site) != before:
        raise AssertionError("13a: the installed copy's directory changed")
    launches = int(re.search(r"^swar_counts launches (\d+)$", r.stderr,
                             re.M).group(1))
    if launches <= 0:
        raise AssertionError("13a: the installed CLI launched no swar_counts")
    say(f"13a installed console script, {BUFFERED_SIZE // MIB} MiB trio: "
        f"{got[0]} bytes, run_host's; wall {wall:.1f} s with process start "
        f"and the cold builds: nvcc {float(kern.group(2)):.2f} s, g++ "
        f"{float(emit.group(2)):.2f} s, into {cache}; swar_counts launches "
        f"{launches}; the installed directory unchanged")

    # (b) cuda_smoke through the console script, same environment
    smoke, smoke_wall = child_json(
        "13b cuda_smoke", [sys.executable, os.path.join(
            REPO, "scripts", "cuda_smoke.py"), "--cli", script], work, env)
    if smoke.get("kernel_cache") != "asserted" or \
            smoke.get("kernels_library") != libs[0][0] or \
            smoke["swar_counts_launches"] <= 0 or smoke["orbit_launches"] <= 0:
        raise AssertionError(f"13b: {smoke}")

    # (c) the fuzzer on the card, from the checkout
    fuzz, fuzz_wall = child_json(
        "13c fuzz_torch", [sys.executable, os.path.join(
            REPO, "scripts", "fuzz_torch.py"), "--device", "cuda", "--trials",
            str(FUZZ_TRIALS), "--seed", "14"], REPO, None)
    if fuzz["failures"] or fuzz["trials"] != FUZZ_TRIALS or \
            fuzz["swar_counts_launches"] <= 0 or fuzz["orbit_launches"] <= 0:
        raise AssertionError(f"13c: {fuzz}")

    # (d) the .deb, extracted, its launcher over 13a's cache
    deb_launches, deb_wall = phase_deb(tmp, home, work, main_src, main_host,
                                       libs[0][0])

    for path, counts in (
            ("installed", {"swar_counts": launches
                           + smoke["swar_counts_launches"],
                           "orbit_resolve": smoke["orbit_launches"]}),
            ("fuzz", {"swar_counts": fuzz["swar_counts_launches"],
                      "orbit_resolve": fuzz["orbit_launches"]}),
            ("deb", {"swar_counts": deb_launches})):
        for name, n in counts.items():
            RESULTS[name]["launches"][path] = n
    say(f"phase 13 on {card_line()}: 13a {wall:.1f} s, 13b {smoke_wall:.1f} "
        f"s, 13c {fuzz_wall:.1f} s ({FUZZ_TRIALS} trials), 13d "
        f"{deb_wall:.1f} s; phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_deb(tmp, home, work, main_src, main_host, kernels_lib):
    """Phase 13d: scripts/build_packages_torch.py builds the port's .deb
    here, `dpkg-deb -x` extracts it, and its launcher scans phase 3's
    corpus on the card with 13a's HOME: `run_host`'s bytes, `swar_counts`
    launched, both libraries loaded from 13a's cache (nothing built: the
    kernels' hash covers only the `csrc/` sources), the extracted tree
    unchanged. Returns (swar_counts launches, the phase's wall)."""
    t_phase = time.perf_counter()
    if shutil.which("dpkg-deb") is None:
        raise AssertionError("13d: this host has no dpkg-deb, which builds "
                             "and extracts the .deb")
    out, root = os.path.join(tmp, "deb"), os.path.join(tmp, "deb_root")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "build_packages_torch.py"), out],
        capture_output=True, text=True, cwd=work, stdin=subprocess.DEVNULL,
        timeout=INSTALLED_TIMEOUT_S)
    build_wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"13d: build_packages_torch.py exit code "
                             f"{r.returncode}\n{r.stderr[-3000:]}")
    (deb,) = os.listdir(out)
    subprocess.run(["dpkg-deb", "-x", os.path.join(out, deb), root],
                   check=True, timeout=INSTALLED_TIMEOUT_S)
    before = tree_of(root)
    dst = os.path.join(tmp, "deb.out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(HOME=home, PYTHONDONTWRITEBYTECODE="1", STRINGSEXT_PROFILE="1")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(root, "usr", "bin",
                                      "stringsext-tpu-torch"),
         "--device", "cuda", "-t", "x", "-e", "UTF-8", "-e", "UTF-16LE",
         "-e", "UTF-16BE", "-p", dst, main_src],
        capture_output=True, text=True, cwd=work, env=env,
        timeout=INSTALLED_TIMEOUT_S, stdin=subprocess.DEVNULL)
    scan_wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"13d: the .deb's launcher exit code "
                             f"{r.returncode}\n{r.stderr[-3000:]}")
    got = sha_of(dst)
    if got != main_host:
        raise AssertionError(f"13d: the .deb's bytes {got} differ from "
                             f"run_host's {main_host}")
    if not re.search(rf"^torch kernels: {re.escape(kernels_lib)} "
                     rf"\(cached\)$", r.stderr, re.M) or \
            "(built in" in r.stderr:
        raise AssertionError(f"13d: the kernels were not loaded from "
                             f"{kernels_lib}, or a library was built\n"
                             f"{r.stderr[-3000:]}")
    if tree_of(root) != before:
        raise AssertionError("13d: the extracted tree changed")
    launches = int(re.search(r"^swar_counts launches (\d+)$", r.stderr,
                             re.M).group(1))
    if launches <= 0:
        raise AssertionError("13d: the .deb's launcher launched no "
                             "swar_counts")
    wall = time.perf_counter() - t_phase
    say(f"13d the .deb ({deb}, {os.path.getsize(os.path.join(out, deb))} "
        f"bytes) built in {build_wall:.1f} s; its launcher, "
        f"{BUFFERED_SIZE // MIB} MiB trio: run_host's bytes, wall "
        f"{scan_wall:.1f} s with process start, kernels (cached) from "
        f"{kernels_lib}, nothing built, swar_counts launches {launches}; the "
        f"extracted tree unchanged; 13d wall {wall:.1f} s")
    return launches, wall


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
            # a PyTorch call that computes it, where one does
            "library_ms": r.get("library_ms"),
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
    t_main = time.perf_counter()

    def done(what):
        say(f"[{what} done at {time.perf_counter() - t_main:.1f} s]")

    try:
        phase_build(dev)
        stateful = stateful_corpus(STATEFUL_SIZE, seed=0)
        pool, oracles = start_oracles(stateful)
        big, trio, other_sets = phase_kernel(dev)
        phase_orbit(dev, stateful)
        phase_feeds(dev, stateful, oracles)
        phase_report_clamp(dev, big)
        pool.shutdown()
        done("phases 1-2")
        main_src, main_host = phase_main_path(dev, tmp)
        phase_goldens(dev, tmp)
        done("phases 3-4")
        phase_step(dev, big)
        phase_lanes(dev, tmp, big)
        done("phases 5-6")
        phase_streaming(dev, tmp)
        done("phase 7")
        two_files, two_host, two_walls = phase_two_files(dev, tmp)
        done("phase 8")
        nine = phase_mesh(dev, tmp, stateful)
        done("phase 9")
        phase_dist(dev, tmp, two_files, two_host, two_walls)
        done("phase 10")
        phase_engine(dev, tmp, stateful)
        done("phase 11")
        phase_process_mesh(dev, tmp, stateful, nine)
        done("phase 12")
        phase_installed(tmp, main_src, main_host)
        done("phase 13")
        say(f"kernel timings on {card_line()}")
        time_swar_counts(dev, big, trio, other_sets)
        time_lanes_kernels(dev, big)
        time_orbit(dev, stateful)
        time_report_clamp(dev, big)
        time_last_set_scan(dev, stateful)
        done("kernel timings")
    finally:
        if pool is not None:  # waits for a running oracle when a phase failed
            pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    check_jax_free()
    say(card_line())
    say(json.dumps(kernels_line()))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pmesh-rank"]:  # a rank of phase 12
        sys.path.insert(0, REPO)
        sys.exit(pmesh_rank(*sys.argv[2:]))
    sys.exit(main())
