"""BENCHMARK.json keeps to the benchmark's contract, and every entry finds
its files by name, so that a new cell or metric is files and entries
only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        names += c["reduced"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    seen = [m["name"] for m in metrics]
    assert len(seen) == len(set(seen))


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for name in CELLS:
        cell = run.Cell(BENCH, name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, name
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_every_entry_resolves_to_its_files(name):
    cell = run.Cell(BENCH, name)
    assert cell.config["argv"] and cell.traffic["mode"] in (
        "buffered", "streamed")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("portbench/") for f in files)
    for m in cell.per_layer:
        assert callable(run.metric_reader(m["name"]))


def _copy_checkout(tmp_path):
    """BENCHMARK.json and portbench/ copied to `tmp_path`, and the bytes
    of each file so copied, by its path there."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p: (tmp_path / p).read_bytes() for p in
            ["BENCHMARK.json"] + [os.path.relpath(os.path.join(d, f),
                                                  tmp_path)
                                  for d, _, fs in os.walk(tmp_path /
                                                          "portbench")
                                  for f in fs]}


def _rewrite_bench(tmp_path, bench):
    (tmp_path / "BENCHMARK.json.new").write_text(json.dumps(bench))
    os.replace(tmp_path / "BENCHMARK.json.new", tmp_path / "BENCHMARK.json")


def _run_in(tmp_path, argv):
    return subprocess.run(argv, cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                          capture_output=True, text=True, timeout=120)


def test_a_new_metric_and_cell_are_picked_up_without_editing_a_file(
        tmp_path):
    before = _copy_checkout(tmp_path)
    (tmp_path / "portbench/metrics/hello.ms_per_GB.py").write_text(
        "def read(ctx):\n    return ctx.ms_per_gb('hello')\n")
    (tmp_path / "portbench/traffic/dense8.json").write_text(json.dumps(
        dict(run.load_json(run.HERE, "traffic", "dense64.json"),
             image_bytes=8 << 20)))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "trio.dense8", "config": "trio",
                               "traffic": "dense8", "chips": 1,
                               "why": "a smaller dense image"})
    bench["per_layer"].append({
        "name": "hello.ms_per_GB", "unit": "ms/GB", "better": "lower",
        "source": "program_span", "layer": "emitter", "moves": "scan_GBps",
        "workloads": ["trio.dense8"]})
    _rewrite_bench(tmp_path, bench)
    code = (
        "from portbench import run\n"
        "cell = run.Cell(run.load_json(run.ROOT, 'BENCHMARK.json'),"
        " 'trio.dense8')\n"
        "names = [m['name'] for m in cell.per_layer]\n"
        "assert 'hello.ms_per_GB' in names, names\n"
        "ctx = run.MetricContext.__new__(run.MetricContext)\n"
        "ctx.scopes, ctx.gb = {'hello': 0.5}, 2.0\n"
        "print(cell.traffic['image_bytes'],"
        " run.metric_reader('hello.ms_per_GB')(ctx))\n")
    out = _run_in(tmp_path, [sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(8 << 20), "250.0"]
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert (tmp_path / p).read_bytes() == data, p


def test_an_appended_entry_is_picked_up_and_keeps_the_contract(tmp_path):
    """One per-layer entry appended after the last, with a reader of its
    own on a scope the port has (`feed.upload`) and listed on one cell:
    that cell reports it and no other does, it reads its scope, and every
    other test of this file passes on the copy."""
    before = _copy_checkout(tmp_path)
    (tmp_path / "portbench/metrics/feed.upload.ms_per_GB.py").write_text(
        "def read(ctx):\n    return ctx.ms_per_gb('feed.upload')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "feed.upload.ms_per_GB", "unit": "ms/GB", "better": "lower",
        "source": "program_span", "layer": "run-table feed",
        "moves": "scan_GBps", "workloads": ["trio.sparse512_stream"]})
    _rewrite_bench(tmp_path, bench)
    code = (
        "from portbench import run\n"
        "bench = run.load_json(run.ROOT, 'BENCHMARK.json')\n"
        "print(*[w['name'] for w in bench['workloads'] if"
        " 'feed.upload.ms_per_GB' in"
        " [m['name'] for m in run.Cell(bench, w['name']).per_layer]])\n"
        "ctx = run.MetricContext.__new__(run.MetricContext)\n"
        "ctx.scopes, ctx.gb = {'feed.upload': 0.5, 'device.feed': 9.0}, 2.0\n"
        "print(run.metric_reader('feed.upload.ms_per_GB')(ctx))\n")
    out = _run_in(tmp_path, [sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["trio.sparse512_stream", "250.0"]
    # the copy's own tests of this file, but the two that copy a checkout
    out = _run_in(tmp_path, [
        sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
        "-p", "no:randomly", "-k", "not picked_up",
        "portbench/tests/test_portbench_contract.py"])
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout and "failed" not in out.stdout
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert (tmp_path / p).read_bytes() == data, p
