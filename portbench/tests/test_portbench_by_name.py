"""Every test of the benchmark finds an entry of BENCHMARK.json by its
name, never by its place in a list, so that appending a configuration,
a cell or a metric breaks no test. A group (`configs`, `workloads`,
`end_to_end`, `per_layer`, and a cell's `end_to_end` and `per_layer`)
is a list, so any subscript of it, or of a name bound to it, takes an
entry by place."""

import ast
import glob
import os

import pytest

from portbench import run

GROUPS = {"configs", "workloads", "end_to_end", "per_layer"}
TESTS = sorted(glob.glob(os.path.join(run.HERE, "tests", "*.py")))


def _is_group(node) -> bool:
    """`x["per_layer"]` and the like, or a cell's `c.per_layer`."""
    if isinstance(node, ast.Subscript):
        key = node.slice
        return isinstance(key, ast.Constant) and key.value in GROUPS
    return isinstance(node, ast.Attribute) and node.attr in GROUPS


def places_taken(source: str) -> list:
    """The lines of `source` at which an entry of a group is taken by its
    place: `bench["per_layer"][-1]`, `bench["configs"][1:]`, or `w[0]`
    after `w = bench["workloads"]`."""
    tree = ast.parse(source)
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_group(node.value):
            aliases |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return sorted(node.lineno for node in ast.walk(tree)
                  if isinstance(node, ast.Subscript)
                  and (_is_group(node.value)
                       or isinstance(node.value, ast.Name)
                       and node.value.id in aliases))


@pytest.mark.parametrize("path", TESTS, ids=os.path.basename)
def test_no_test_takes_an_entry_by_its_place(path):
    with open(path) as f:
        assert places_taken(f.read()) == [], path


@pytest.mark.parametrize("source,lines", [
    ('BENCH = {}\nentry = 1\nassert BENCH["per_layer"][-1] is entry\n',
     [3]),
    ('w = bench["workloads"][0]["name"]\n', [1]),
    ('c = bench["configs"][1:]\n', [1]),
    ('cell.per_layer[2]\n', [1]),
    ('pl = BENCH["per_layer"]\nx = 0\nfirst = pl[x]\n', [3]),
    ('e = {m["name"]: m for m in BENCH["per_layer"]}["feed.ms_per_GB"]\n',
     []),
    ('n = len(BENCH["workloads"])\nBENCH["per_layer"].append({})\n', []),
    ('names = [m["name"] for m in cell.per_layer]\nnames.count("x")\n', []),
    ('e2e = {m["name"]: m for m in BENCH["end_to_end"]}\ne2e["setup_s"]\n',
     []),
])
def test_the_scan_tells_a_place_from_a_name(source, lines):
    assert places_taken(source) == lines
