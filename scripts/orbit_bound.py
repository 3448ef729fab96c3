"""What bounds the orbit kernel (`csrc/orbit_resolve.cu`) on the card: its
look-back across tiles, its scans inside a tile, its walks, or its loads
and stores?

    python3 scripts/orbit_bound.py [SASS_FILE]        (needs one CUDA card)

As `scripts/swar_lanes_bound.py` does for its kernel, the script copies
`stringsext_tpu_torch/csrc/` to a temporary directory, makes variants of
`orbit_resolve.cu` there by replacing a few lines of the source (it stops
if a line it replaces has changed), builds each with nvcc into its own
library, and times them in turns with CUDA events (runs of 10 launches,
20 readings) on the step fields of the feed's 64 MiB Shift_JIS piece of
`corpus.stateful_corpus` and of an 8 MiB piece from its middle
(`chip_smoke.piece_steps` / `chunk_steps`):

- as-is           the kernel as the port builds it;
- no-look-back    every tile entered DEAD, no status word read or written:
                  the time without the composition across tiles;
- no-scans        also no composition inside a tile (every segment
                  entered DEAD): loads, codes, the segment maps, one
                  forward walk and the stores;
- memory-only     the codes' bits stored as the mask, with no map, walk or
                  scan: the time of the loads, the codes and the stores;
- no-wait         the look-back takes a predecessor that has not yet
                  published as the identity instead of waiting for it: the
                  time of its reads and compositions without its waits;
- no-fast-path    every segment takes the codes' and maps' general path
                  (each position's code and dead bit one by one);
- rounds-1        one round of 8192 positions a tile instead of two: twice
                  the tiles to look back over;
- acquire-release the status words read with ld.acquire.gpu and written
                  with st.release.gpu instead of relaxed accesses.

A variant that does not build is left out with nvcc's message. The
variants without the look-back or the scans give wrong masks; they are
timed only. The as-is variant must equal the port's own
`_orbit_mask_blocked`, whose wrapper is timed in the same turns ("port
wrapper"). For the as-is variant it also prints the kernel's instructions
by opcode (`cuobjdump -sass`) and writes the disassembly to SASS_FILE.
Every line names the card and its power limit.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LOOK_BACK = "    const uint32_t entry = look_back(status, tile, agg, lane);\n"
ROUND_SCAN = """    uint32_t inc = map;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc = compose(o, inc);
    }
    uint32_t excl = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) excl = kIdent;
    if (lane == 31) warp_map[r * kWarps + warp] = inc;
"""
MAPS_FROM = "    // 2. the segment's map, by the exits of the next four positions\n"
MAPS_TO = "    kept[r][threadIdx.x] = "
MARKS_FROM = "    // the marks: a forward walk in registers, or the general path's walk\n"
MARKS_TO = "    mk &= below_n(rem_of(n, base));\n"
ROUNDS = "constexpr int kRounds = 2;\n"
SPIN = """    if ((ready & need) != need) {
      __nanosleep(32);
      continue;
    }
"""


def replace(src, old, new):
    assert old in src, old
    return src.replace(old, new)


def no_look_back(src):
    # reads agg so that the tile's scan stays
    return replace(src, LOOK_BACK, "    const uint32_t entry = agg == 0x7FFFu ? 0u : kDead;\n")


def no_scans(src):
    src = replace(src, ROUND_SCAN, """    const uint32_t excl = map == 0x7FFFu ? kIdent : const_map(kDead);
    if (lane == 31) warp_map[r * kWarps + warp] = map;
""")
    return no_look_back(src)


def memory_only(src):
    a, b = src.index(MAPS_FROM), src.index(MAPS_TO)
    src = src[:a] + "    const uint32_t excl = kIdent;\n" + src[b:]
    a, b = src.index(MARKS_FROM), src.index(MARKS_TO)
    src = src[:a] + "    uint32_t mk = k.x ^ k.y ^ k.z ^ x;\n" + src[b:]
    return no_look_back(src)


def no_wait(src):
    # unpublished predecessors count as the identity: no spinning
    return replace(src, SPIN, "")


def no_fast_path(src):
    return replace(src, "    const bool fast = bad < 4 && nrem >= kSeg + 4;\n",
                   "    const bool fast = bad > 0xFFFFFFF0u;\n")


def rounds(n):
    return lambda src: replace(src, ROUNDS, f"constexpr int kRounds = {n};\n")


def acquire_release(src):
    src = replace(src, "ld.relaxed.gpu", "ld.acquire.gpu")
    return replace(src, "st.relaxed.gpu", "st.release.gpu")


VARIANTS = {
    "as-is": None,
    "no-look-back": no_look_back,
    "no-scans": no_scans,
    "memory-only": memory_only,
    "no-wait": no_wait,
    "no-fast-path": no_fast_path,
    "rounds-1": rounds(1),
    "acquire-release": acquire_release,
}

ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def build(name, tmp):
    from stringsext_tpu_torch import _build

    d = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "orbit_resolve.cu")
    if VARIANTS[name] is not None:
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(VARIANTS[name](src))
    lib = os.path.join(d, "lib.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                        path], capture_output=True, text=True)
    if r.returncode != 0:
        if name == "as-is":
            raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
        print(f"{name}: nvcc failed, left out\n{r.stdout}{r.stderr}", flush=True)
        return None, [], lib
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    fn = ctypes.CDLL(lib).orbit_resolve_launch
    fn.restype, fn.argtypes = ctypes.c_int, ARGS
    return fn, regs, lib


def main():
    import chip_smoke
    from stringsext_tpu_torch.corpus import stateful_corpus
    from stringsext_tpu_torch.ops.classify_cjk import _orbit_mask_blocked
    from swar_lanes_bound import sass_histogram

    if not torch.cuda.is_available():
        print("orbit_bound: torch finds no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    raw = stateful_corpus(chip_smoke.STATEFUL_SIZE, seed=0)
    fields = {"64 MiB": chip_smoke.piece_steps(raw, dev)["Shift_JIS"],
              "8 MiB": chip_smoke.chunk_steps(raw, dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    tmp = tempfile.mkdtemp(prefix="orbit_bound_")
    try:
        fns = {}
        for name in VARIANTS:
            fn, regs, lib = build(name, tmp)
            if fn is None:
                continue
            fns[name] = fn
            print(f"{name}: {'; '.join(regs)}", flush=True)
            if name == "as-is":
                sass = sys.argv[1] if len(sys.argv) > 1 else None
                for kernel, ops in (sass_histogram(lib, sass) or {}).items():
                    print(f"  {kernel}: {sum(ops.values())} instructions: "
                          + ", ".join(f"{k} {n}" for k, n in ops.most_common()),
                          flush=True)
        for what, (step, n, start) in fields.items():
            cap = step.numel()
            out = torch.empty(cap, dtype=torch.bool, device=dev)
            # room for the ticket and a word a tile at the smallest tile
            scratch = torch.empty(cap // 4096 + 2, dtype=torch.int32, device=dev)

            def launch(fn, step=step, n=n, start=start, cap=cap, out=out,
                       scratch=scratch):
                err = fn(step.data_ptr(), cap, n, start, scratch.data_ptr(),
                         out.data_ptr(), 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            launch(fns["as-is"])
            torch.cuda.synchronize()
            if not torch.equal(out, _orbit_mask_blocked(step, n, start)):
                raise AssertionError("the as-is variant != _orbit_mask_blocked")
            calls = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
            calls["port wrapper"] = (
                lambda step=step, n=n, start=start: _orbit_mask_blocked(step, n, start))
            bound = 5 * cap / chip_smoke.HBM_BYTES_PER_S * 1e3
            for turn in range(2):  # in turns: a drift would show between them
                for name, call in calls.items():
                    ms = chip_smoke.cuda_ms(call)
                    print(f"turn {turn} {name} {what} ({cap} positions) on {card}: "
                          f"min/median/max {ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} "
                          f"ms a launch in runs of 10, {100 * bound / ms[1]:.0f}% "
                          f"of the {bound:.4f} ms bound", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
