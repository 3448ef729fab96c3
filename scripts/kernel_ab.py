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
times), the timings of all six kernels, and the device profiler at 64 MiB.
A failing phase stops the run with its exit code.
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
profile_device.profile(c.SIZE, 5, dev, out=lambda line: c.say('  ' + line))
"""


def main() -> int:
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    for turn, d in enumerate(dirs):
        label = f"turn {turn}: {d}"
        r = subprocess.run([sys.executable, "-c", PHASES.format(label=label)],
                           cwd=os.path.abspath(d))
        if r.returncode != 0:
            print(f"{label}: exit code {r.returncode}", file=sys.stderr)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
