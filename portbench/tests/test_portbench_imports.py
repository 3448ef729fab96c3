"""Nothing a cell runs loads JAX, flax or the JAX package, and the plain
reference loads nothing of the port. Top-level module names are compared
whole: `stringsext_tpu_torch` is the port, `stringsext_tpu` the JAX
package."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "stringsext_tpu", "bench",
             "__graft_entry__"}
CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")
         ["workloads"]]


def _in_child(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         env=dict(os.environ, PYTHONPATH=run.ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_compared_whole():
    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))
    sys_modules = dict(sys.modules)
    try:
        sys.modules["stringsext_tpu_torch_fake"] = sys
        sys.modules["benchmarks_fake.x"] = sys
        assert not set(run.forbidden_modules()) & {"stringsext_tpu_torch"}
        sys.modules["bench"] = sys
        assert "bench" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(sys_modules)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_run_loads_nothing_forbidden(cell):
    code = f"""
import json, sys
from portbench import run, control, trace, check, images
from portbench.tests.small import small_traffic
import stringsext_tpu_torch.parallel.mesh
bench = run.load_json(run.ROOT, "BENCHMARK.json")
c = run.Cell(bench, {cell!r})
for m in c.per_layer:
    run.metric_reader(m["name"])
rc = run.main(["--workload", {cell!r}, "--seed", "5", "--seconds", "0.01"],
              device="cpu", traffic=small_traffic(c.traffic, 1 << 20))
tops = sorted({{n.split(".", 1)[0] for n in sys.modules}})
print(json.dumps({{"rc": rc, "tops": tops}}))
"""
    got = _in_child(code)
    assert got["rc"] == 0
    assert "stringsext_tpu_torch" in got["tops"] and "torch" in got["tops"]
    assert not set(got["tops"]) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
from portbench import check, images
from portbench.reference import regions
ref = regions.Reference(["-t", "x", "-u", "Asian", "-e", "Shift_JIS",
                         "-e", "ISO-2022-JP", "-e", "UTF-8", "-e", "UTF-16LE"])
data, marks = images.firmware(1 << 20, 3)
cb = ref.calm_boundaries(data)
lo = int(cb[cb >= 1 << 18][0]); hi = int(cb[cb >= lo + 8192][0])
lines = ref.region_lines(data, lo, hi)
tops = sorted({n.split(".", 1)[0] for n in sys.modules})
print(json.dumps({"tops": tops, "lines": len(lines)}))
"""
    got = _in_child(code)
    assert got["lines"] > 0
    assert "stringsext_tpu_torch" not in got["tops"]
    assert "torch" not in got["tops"]
    assert not set(got["tops"]) & FORBIDDEN
