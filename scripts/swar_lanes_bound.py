"""What bounds `flagship_swar_lanes` on the card: its arithmetic, its
stores, or how many threads are resident?

    python3 scripts/swar_lanes_bound.py [MiB [SASS_FILE [FILTERS]]]

(needs one CUDA card; FILTERS names a set of `corpus.SWAR_LANES_FILTERS`,
by default the flagship's default filters).

The card's profilers may be out of reach, so the question is put to the
kernel itself. The script copies `stringsext_tpu_torch/csrc/` to a
temporary directory, makes variants of `swar_lanes.cu` there by replacing
a few lines of the source (it stops if a line it replaces has changed),
builds each with nvcc into its own library, and times them in turns on the
benchmark corpus with CUDA events (runs of 10 launches, 20 readings):

- as-is            the kernel as the port builds it;
- no-stores        the same arithmetic, its results stored only under a
                   condition that the compiler cannot decide and that
                   holds for next to no thread (the XOR of all its result
                   words equals a number made from the stream's length):
                   the time of loads and arithmetic alone;
- no-arithmetic    the loaded words stored as they are, three times: the
                   time of the kernel's memory traffic alone;
- threads-128/512  the block size changed from 256;
- regs-N           `__launch_bounds__(256, N)`: N blocks resident an SM;
- gather-planes    the window's bit planes by 24 multiply-gathers of 8
                   bytes (`plane8`) instead of three bit transposes;
- word-table       the UTF-8 filter looked up in the record's 256-bit table
                   instead of a table of 256 bytes;
- multiply-spread  the masks spread to bytes four positions a multiply
                   instead of sixteen positions by two bit transposes;
- compare-intervals  the UTF-16 interval test as a compare, a select and an
                   OR a unit and interval instead of two subtractions and
                   one logic operation.

For the as-is variant it also prints the compiled kernels' instructions by
opcode (`cuobjdump -sass`) and writes the disassembly to SASS_FILE. The as-is variant must equal the port's own `flagship_swar_lanes`, whose
wrapper is timed in the same turns ("port wrapper": the launch through
`ops/swar.py`, with its host work and its newly allocated output), beside
the host's time to enqueue one launch either way. Every line names the
card and its power limit.
"""

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STORES = """  out[i] = make_int4(v8[0], v8[1], v8[2], v8[3]);
  out[per_mission + i] = make_int4(vle[0], vle[1], vle[2], vle[3]);
  out[2 * per_mission + i] = make_int4(vbe[0], vbe[1], vbe[2], vbe[3]);
"""
ARITHMETIC_FROM = "  window_planes(c, W);\n"
ARITHMETIC_TO = "  const int64_t per_mission = nwords / 4;  // int4s\n"
BOUNDS = "__global__ void __launch_bounds__(kLanesThreads)\nflagship_swar_lanes_kernel("
THREADS = "constexpr int kLanesThreads = 256;"


def no_stores(src):
    assert STORES in src
    # The condition reads every result, so none of the arithmetic can move
    # into the branch, and compares with a number the compiler cannot know.
    every = " ^ ".join(f"{v}[{q}]" for v in ("v8", "vle", "vbe")
                       for q in range(4))
    return src.replace(
        STORES, f"  if (({every}) == (uint32_t)nwords * 0x9E3779B9u + 0x80u) {{\n"
        + STORES + "  }\n")


def no_arithmetic(src):
    a, b = src.index(ARITHMETIC_FROM), src.index(ARITHMETIC_TO)
    plain = """  uint32_t v8[4], vle[4], vbe[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v8[q] = c[1 + q];
    vle[q] = c[1 + q] ^ c[0];
    vbe[q] = c[1 + q] ^ c[5];
  }
"""
    return src[:a] + plain + src[b:]


def resident(n):
    def patch(src):
        assert BOUNDS in src
        return src.replace(BOUNDS, BOUNDS.replace("(kLanesThreads)",
                                                  f"(kLanesThreads, {n})"))
    return patch


def threads(n):
    def patch(header):
        assert THREADS in header
        return header.replace(THREADS, f"constexpr int kLanesThreads = {n};")
    return patch


PLANES_FROM = "  uint32_t lo[3], hi[3];  // planes 0-3 and 4-7"
PLANES_TO = "// One mission's field bits as window masks"


def gather_planes(header):
    """window_planes as 24 gathers of plane8 instead of three transposes."""
    a, b = header.index(PLANES_FROM), header.index(PLANES_TO)
    return header[:a] + """#pragma unroll
  for (int k = 0; k < 8; ++k)
    W[k] = (plane8(c[0], c[1], k) | (plane8(c[2], c[3], k) << 8) | (plane8(c[4], c[5], k) << 16))
           << (kOwnBit - 4);
}

""" + header[b:]


LOOKUP = "byte_table_passes(c, pass8)"
SPREAD = """  field_words(f8.m, v8);
  field_words(m16, v16);  // a word: LE 4q, BE 4q, LE 4q+2, BE 4q+2
"""


def word_table(src):
    """The UTF-8 filter looked up in the record's 8 words, a shift by the
    byte's value a lookup, instead of in the table of 256 bytes."""
    assert LOOKUP in src
    return src.replace(
        LOOKUP, "table_passes(c, reinterpret_cast<const uint32_t*>(r8 + kTabA))")


FIELD_BYTES = """
// A mask's four bits times 0x00204081 land at bits 0, 8, 16 and 24 (bit j
// meets the multiplier's bit 7j), and no two terms share a bit.
__device__ __forceinline__ uint32_t field_bytes(const uint32_t (&m)[7], int q) {
  uint32_t f = 0;
#pragma unroll
  for (int b = 0; b < 7; ++b) {
    const uint32_t n = (m[b] >> (kOwnBit + 4 * q)) & 0xFu;
    f |= (n * (0x00204081u << b)) & (0x01010101u << b);
  }
  return f;
}
"""
KERNEL = "// kGrep: a mission has a grep char."


def multiply_spread(src):
    """The masks spread back to bytes four positions a multiply instead of
    by two bit transposes (field_words)."""
    assert SPREAD in src and KERNEL in src
    src = src.replace(KERNEL, FIELD_BYTES + "\n" + KERNEL)
    return src.replace(SPREAD, """#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v8[q] = field_bytes(f8.m, q);
    v16[q] = field_bytes(m16, q);
  }
""")


INTERVALS_FROM = "  int miss[8];\n"
INTERVALS_TO = "  uint32_t grep_hit = 0;\n  if (grep >= 0) {\n#pragma unroll\n    for (int j = 0; j < 8; ++j) grep_hit |= cp[j] == grep"


def compare_intervals(header):
    """The UTF-16 interval test as a compare, a select and an OR a unit and
    interval instead of two subtractions and a logic operation."""
    a = header.index(INTERVALS_FROM)
    b = header.index(INTERVALS_TO, a)
    return header[:a] + """  uint32_t passes = 0;
  for (int k = 0; k < niv; ++k) {
    const int lo = iv[2 * k];
    const unsigned span = (unsigned)(iv[2 * k + 1] - lo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      passes |= ((unsigned)(cp[j] - lo) <= span) ? (1u << (2 * j)) : 0u;
  }
  const uint32_t missed = ~passes;
""" + header[b:]


# name -> (patch of swar_lanes.cu, patch of mission_fields.cuh)
VARIANTS = {
    "as-is": (None, None),
    "no-stores": (no_stores, None),
    "no-arithmetic": (no_arithmetic, None),
    "threads-128": (None, threads(128)),
    "threads-512": (None, threads(512)),
    "regs-6": (resident(6), None),
    "regs-8": (resident(8), None),
    "gather-planes": (None, gather_planes),
    "word-table": (word_table, None),
    "multiply-spread": (multiply_spread, None),
    "compare-intervals": (None, compare_intervals),
}

ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def build(name, tmp):
    from stringsext_tpu_torch import _build

    d = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, d)
    for fname, patch in zip(("swar_lanes.cu", "mission_fields.cuh"),
                            VARIANTS[name]):
        if patch is not None:
            path = os.path.join(d, fname)
            with open(path) as f:
                src = f.read()
            with open(path, "w") as f:
                f.write(patch(src))
    lib = os.path.join(d, "lib.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                        os.path.join(d, "swar_lanes.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln]
    fn = ctypes.CDLL(lib).swar_lanes_launch
    fn.restype, fn.argtypes = ctypes.c_int, ARGS
    return fn, regs, lib


def sass_histogram(lib, sass_path=None):
    """Instructions by opcode of every kernel in `lib`, from `cuobjdump
    -sass` (the static count: the kernel is unrolled and has one loop, over
    the UTF-16 intervals), or None where the toolkit has no cuobjdump; the
    whole disassembly goes to `sass_path` where one is given."""
    from stringsext_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    if sass_path:
        os.makedirs(os.path.dirname(os.path.abspath(sass_path)), exist_ok=True)
        with open(sass_path, "w") as f:
            f.write(r.stdout)
    out, name = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def main():
    import chip_smoke
    from stringsext_tpu_torch.corpus import (
        SWAR_LANES_FILTERS,
        flagship_missions,
        make_corpus,
    )
    from stringsext_tpu_torch.ops import swar

    if not torch.cuda.is_available():
        print("swar_lanes_bound: torch finds no CUDA device", file=sys.stderr)
        return 1
    mib = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    filters = sys.argv[3] if len(sys.argv) > 3 else "flagship"
    p = swar.swar_params(flagship_missions(**SWAR_LANES_FILTERS[filters]).v)
    any_grep = int(any(g >= 0 for g in p["greps"]))
    w = torch.from_numpy(make_corpus(mib << 20, seed=0)).to(dev).view(
        torch.int32).reshape(-1, 128)
    want = torch.stack(swar.flagship_swar_lanes(w, **p))
    _table, tab = swar._device_table(
        swar._freeze(swar.flagship_specs(**p)), dev)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tmp = tempfile.mkdtemp(prefix="swar_lanes_bound_")
    try:
        fns = {}
        for name in VARIANTS:
            fns[name], regs, lib = build(name, tmp)
            print(f"{name}: {'; '.join(regs)}", flush=True)
            if name == "as-is":
                sass = sys.argv[2] if len(sys.argv) > 2 else None
                for kernel, ops in (sass_histogram(lib, sass) or {}).items():
                    print(f"  {kernel}: {sum(ops.values())} instructions: "
                          + ", ".join(f"{k} {n}" for k, n in ops.most_common()),
                          flush=True)

        def launch(fn):
            err = fn(w.data_ptr(), w.shape[0], out.data_ptr(), tab.data_ptr(),
                     any_grep, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(fns["as-is"])
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError("the as-is variant != flagship_swar_lanes")
        calls = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
        calls["port wrapper"] = lambda: swar.flagship_swar_lanes(w, **p)
        for name in ("as-is", "port wrapper"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                calls[name]()
            host = (time.perf_counter() - t0) / 200
            torch.cuda.synchronize()
            print(f"{name}: the host enqueues one launch in {host * 1e6:.1f} us",
                  flush=True)
        for turn in range(2):  # in turns: a drift would show between them
            for name, call in calls.items():
                ms = chip_smoke.cuda_ms(call)
                print(f"turn {turn} {name} {mib} MiB {filters} on {card}: min/"
                      f"median/max "
                      f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms a launch in "
                      f"runs of 10", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
