"""Kernel, step and profiler timings of several checkouts in turns, on one
card in one run.

    python3 scripts/kernel_ab.py DIR [DIR ...]       (needs one CUDA card)

Readings of two runs differ by a few percent for kernels and by tens of
percent for paths that follow the host, so two commits are compared only
inside one run: unpack each with `git archive` and name the directories
in the order parent, change, change, parent. For every DIR in turn a new
process runs, from that checkout's own `chip_smoke.py` and package: the
build, phase 2 (`swar_counts` against its plain version), phase 5 (the
field kernels against their plain versions, the step's routes and their
times), the timings of all six kernels, the orbit kernel's timings
(`time_orbit` over the stateful corpus) and, at its 64 MiB Shift_JIS
piece and an 8 MiB piece from the corpus' middle, its time by kernel
name (`torch.profiler`, device time of 20 calls: the passes of a
multi-pass design and the launcher's memset apart), and the device
profiler at 64 MiB. A failing phase stops the run with its exit code.
"""

import os
import subprocess
import sys

PHASES = """
import torch, chip_smoke as c
from stringsext_tpu_torch import profile_device
dev = torch.device('cuda', 0)
c.say('== ' + {label!r} + ' on ' + c.card_line())
c.phase_build(dev)
big, trio, other = c.phase_kernel(dev)
c.phase_step(dev, big)
c.time_swar_counts(dev, big, trio, other)
c.time_lanes_kernels(dev, big)
from stringsext_tpu_torch.corpus import stateful_corpus
stateful = stateful_corpus(c.STATEFUL_SIZE, seed=0)
c.time_orbit(dev, stateful)
orbit_split(c, dev, stateful)
profile_device.profile(c.SIZE, 5, dev, out=lambda line: c.say('  ' + line))
"""

# The same code for every checkout: it reaches the orbit only through the
# package's wrapper and `cjk_pre_lanes`, which every checkout since the
# orbit kernel has.
ORBIT_SPLIT = """
def orbit_split(c, dev, stateful):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from stringsext_tpu_torch.ops import device_events as de
    from stringsext_tpu_torch.ops.classify_cjk import (
        _orbit_mask_blocked, cjk_pre_lanes)

    MIB = 1 << 20
    piece = c.piece_steps(stateful, dev)["Shift_JIS"]
    lo = 8 * MIB - de.LEFT_CTX
    b = torch.from_numpy(stateful[lo:16 * MIB + de.RIGHT_HALO]).to(dev)
    chunk = (cjk_pre_lanes(b, "shift_jis", b.numel())[1],
             8 * MIB + de.LEFT_CTX, de.LEFT_CTX)
    for what, (step, n, start) in (("64 MiB piece", piece),
                                   ("8 MiB piece", chunk)):
        t = c.cuda_ms(lambda: _orbit_mask_blocked(step, n, start))
        c.say(f"  orbit {what} ({step.numel()} bytes): min/median/max "
              f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} ms a launch in runs "
              f"of 10")
        for _ in range(3):
            _orbit_mask_blocked(step, n, start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                _orbit_mask_blocked(step, n, start)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us > 0:
                rows.append((us, e.key, e.count))
        total = sum(r[0] for r in rows)
        for us, key, count in sorted(rows, reverse=True):
            c.say(f"    {key}: {count} calls, {us / count / 1e3:.4f} ms a "
                  f"call, {100 * us / max(total, 1e-9):.1f}% of device time")
"""


def main() -> int:
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    for turn, d in enumerate(dirs):
        label = f"turn {turn}: {d}"
        r = subprocess.run([sys.executable, "-c",
                            ORBIT_SPLIT + PHASES.format(label=label)],
                           cwd=os.path.abspath(d))
        if r.returncode != 0:
            print(f"{label}: exit code {r.returncode}", file=sys.stderr)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
