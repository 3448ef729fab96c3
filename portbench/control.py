#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

    python3 portbench/control.py --workload trio.dense64 --seed 7 [--seed 8 ...]

For each seed it makes the cell's images as a run does, draws the same
regions, and puts in the port's place the plain reference with the
carry dropped at every decode window (`regions.region_lines(...,
carry=False)`: a string is no longer found whole across the reference
CLI's windows and slices). It prints, for every image, the count that a
run compares as `region_lines_wrong` for the control (which must come
out above the limit 0), the reference's line count and the regions'
sizes. It needs no card: the control and the reference run on
the host, at the cell's own sizes. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, images  # noqa: E402
from portbench.reference.regions import Reference  # noqa: E402
from portbench.run import Cell, load_json, regions_of  # noqa: E402


class _Lines:
    """A stand-in for `check.Parsed` whose lines are given by region."""

    def __init__(self, by_region):
        self.by_region = by_region

    def lines_in(self, lo, hi):
        return self.by_region[(lo, hi)]


def control_readings(cell: Cell, seed: int, traffic=None) -> list:
    """[{image, regions, region_bytes, reference_lines, control_wrong}]
    for the cell's images at `seed`."""
    t = traffic or cell.traffic
    ref = Reference(cell.config["argv"])
    make = images.KINDS[t["image"]]
    out = []
    for i in range(int(t["images"])):
        data, marks = make(int(t["image_bytes"]), images.image_seed(seed, i))
        regs = regions_of(t, ref, data, marks, seed, i)
        ctl = _Lines({r: ref.region_lines(data, *r, carry=False)
                      for r in regs})
        wrong, total = check.region_mismatches(ctl, ref, data, regs)
        out.append({"image": i, "regions": len(regs),
                    "region_bytes": int(sum(b - a for a, b in regs)),
                    "reference_lines": total, "control_wrong": wrong})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    a = p.parse_args(argv)
    cell = Cell(load_json(ROOT, "BENCHMARK.json"), a.workload)
    for seed in a.seed:
        t0 = time.perf_counter()
        rows = control_readings(cell, seed)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "images": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
