"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once at real size and checks them, in six
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
   NUL-accepting filter, 16 single-byte missions, a 32-mission group) and
   corpora (64 MiB bench, all byte pairs, all-0x00, all-0xFF, unaligned,
   1 / 7 / 8 / 9 / 131071 rows, and multi-byte chars and surrogate pairs
   across every 16-byte, 512-byte and 4096-byte seam and at both stream
   edges), in both hot_only modes, with and without xor_word;
3. the main path - the port's CLI scan (`stringsext_tpu_torch.run.run`,
   device "cuda") of a 256 MiB bench corpus with UTF-8 + UTF-16LE +
   UTF-16BE must write the same bytes as the port's host path
   (`run.run_host`: the whole stream through the C++ emitter, no hot
   map); the kernel's launch counter is reset just before the port's run
   and must be positive after it;
4. goldens - every frozen golden case of tests/golden_extra whose
   missions are all of ported kinds must come out byte for byte through
   the port on the card and through `run_host`;
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
   timed with CUDA events, the swar route also at 256 MiB, with each
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
   fallback: the port's scan of a 256 MiB bench corpus with missions
   `swar_counts` cannot take (macintosh, UTF-8, UTF-16LE under a 64-
   interval AF filter), with the run-table feed on and off, must write
   `run_host`'s bytes without launching `swar_counts`; (d) the device
   profiler (`stringsext_tpu_torch.profile_device`) at 64 MiB: all six
   variants must report, and its kernel variants must launch their
   kernels.

Then every kernel and its plain version are timed at 64 MiB with CUDA
events: 20 repetitions, each a run of 10 launches (the minimum, median
and maximum of the per-launch time; a single launch between two events
also counts the wrapper's host work, and its median is printed beside).
Each kernel's bound is the bytes it must move (every input read once,
every output written once) over 3.35 TB/s, the data sheet's figure for an
H100 SXM; its operations are 32-bit integer logic, for which the data
sheet gives no peak, so no kernel's bound is by operations.

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
CLI_SIZE = 256 * MIB  # the file the CLI scans
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
    from stringsext_tpu_torch.ops.specs import swar_mission_spec
    from stringsext_tpu_torch.ops.swar import swar_counts, swar_counts_ref

    def specs(**kw):
        out = tuple(swar_mission_spec(m) for m in Missions.new(**kw).v)
        assert all(sp is not None for sp in out), kw
        return out

    trio = specs(flag_encoding=["UTF-8", "UTF-16LE", "UTF-16BE"])
    names = ["ascii"] + list(ALL_ENCODING_NAMES)
    group = tuple(sp for sp in (swar_mission_spec(m) for m in
                                Missions.new(flag_encoding=names).v)
                  if sp is not None)
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
    say(f"phase 2: {ncmp} comparisons, max abs difference "
        f"{RESULTS['swar_counts']['err']} (tolerance 0)")
    return big, trio, {"sbyte-16": sbyte16, f"hot-group-{len(group)}": group}


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
    for sname, sp in other_sets.items():
        ms = cuda_ms(lambda: swar_counts(w, sp, hot_only=True))
        say(f"swar_counts {sname} {what} hot_only: min/median/max "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms (bound "
            f"{nbytes(sp) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    time_kernel("swar_counts", f"swar_counts trio {what} hot_only",
                lambda: swar_counts(w, trio, hot_only=True),
                lambda: swar_counts_ref(w, trio, hot_only=True),
                nbytes(trio))


def cli_scan(label, argv, dst, dev=None):
    """One scan into the file `dst`: the port on `dev`, or `run_host`
    when `dev` is None. Returns (size, sha256, wall s, peak bytes)."""
    from stringsext_tpu_torch.cli import parse_args
    from stringsext_tpu_torch.run import run, run_host

    with open(dst, "wb") as out:
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
    mem = "" if dev is None else (f", peak device memory {peak} bytes "
                                  f"({peak / 2**30:.2f} GiB)")
    say(f"{label}: {size} bytes sha256 {sha[:16]} wall {wall:.3f} s{mem}")
    return size, sha


def phase_main_path(dev, tmp):
    from stringsext_tpu_torch.corpus import make_corpus
    from stringsext_tpu_torch.ops import swar

    src = os.path.join(tmp, "corpus.bin")
    make_corpus(CLI_SIZE, seed=0).tofile(src)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE", src]
    what = f"main path, {CLI_SIZE // MIB} MiB trio"
    swar.swar_counts.launches = 0
    port = cli_scan(f"{what}, port on the card", argv,
                    os.path.join(tmp, "port.out"), dev)
    count_launches(f"cli flagship scan, {CLI_SIZE // MIB} MiB",
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
    from stringsext_tpu_torch.mission import Missions
    from stringsext_tpu_torch.run import (
        SliceError,
        check_slice,
        run,
        run_host,
    )

    def in_slice(argv):
        a = parse_args(argv + [os.devnull])
        try:
            check_slice(a, Missions.from_args(a))
            return True
        except SliceError:
            return False

    single = os.path.join(tmp, "main.bin")
    with open(single, "wb") as f:
        f.write(corpus_main())
    multi = []
    for i, b in enumerate(corpus_files()):
        multi.append(os.path.join(tmp, f"f{i}.bin"))
        with open(multi[-1], "wb") as f:
            f.write(b)
    ncases = 0
    for name, argv, is_multi in CASES:
        if not in_slice(argv):
            continue
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
    if ncases < 10:
        raise AssertionError(f"only {ncases} golden cases are in the slice")
    say(f"phase 4: {ncases} golden cases byte-identical on the card and "
        f"through run_host")


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
    larger = torch.from_numpy(make_corpus(CLI_SIZE, seed=0)).to(dev)
    step, _ = step_mod.entry(dev)
    ms = cuda_ms(lambda: step(larger, xor_word=0x01010101), inner=1)
    say(f"step route swar {CLI_SIZE // MIB} MiB: min/median/max {ms[0]:.4f} "
        f"/ {ms[1]:.4f} / {ms[2]:.4f} ms "
        f"({CLI_SIZE / (ms[1] * 1e-3) / 1e9:.2f} GB/s)")


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
    make_corpus(CLI_SIZE, seed=0).tofile(src)
    argv = ["-t", "x", "-e", "macintosh", "-e", "UTF-8", "-e", "UTF-16LE",
            "-a", "0x" + "5" * 32, src]
    dst = os.path.join(tmp, "lanes.out")
    what = f"lanes fallback, {CLI_SIZE // MIB} MiB"
    outs = {"host": cli_scan(f"{what}, port host path (whole stream, no hot "
                             f"map)", argv, dst)}
    saved = os.environ.get("STRINGSEXT_RUNTABLE_FEED")
    try:
        for feed in ("1", "0"):
            os.environ["STRINGSEXT_RUNTABLE_FEED"] = feed
            swar.swar_counts.launches = 0
            outs[feed] = cli_scan(f"{what}, port on the card, feed "
                                  f"{'on' if feed == '1' else 'off'}", argv,
                                  dst, dev)
            if swar.swar_counts.launches:
                raise AssertionError("swar_counts ran for missions without "
                                     "a swar spec")
    finally:
        if saved is None:
            os.environ.pop("STRINGSEXT_RUNTABLE_FEED", None)
        else:
            os.environ["STRINGSEXT_RUNTABLE_FEED"] = saved
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

    say(card_line())  # name, power limit
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_build(dev)
        big, trio, other_sets = phase_kernel(dev)
        phase_main_path(dev, tmp)
        phase_goldens(dev, tmp)
        phase_step(dev, big)
        phase_lanes(dev, tmp, big)
        say(f"kernel timings on {card_line()}")
        time_swar_counts(dev, big, trio, other_sets)
        time_lanes_kernels(dev, big)
    finally:
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
