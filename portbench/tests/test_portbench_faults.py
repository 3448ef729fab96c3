"""Whole runs of the harness on the CPU, without its look for a card, at
a small size, with the timed path broken underneath: `correct` must come
out false for each fault a cell can have. The faults are planted in the
port's emitter (`native.native_scan`, where the findings are produced)."""

import copy
import json

import numpy as np
import pytest

from portbench import run
from portbench.tests.small import small_traffic
from stringsext_tpu_torch import native

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
STREAMED = [n for n in CELLS
            if run.Cell(BENCH, n).traffic["mode"] == "streamed"]


CHUNK = 256 << 10  # the streamed path's chunk in these runs: 4 an image


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Stream in chunks of CHUNK bytes, so that a small image crosses
    chunk seams and carries state from chunk to chunk."""
    from stringsext_tpu_torch import run as port_run

    f = port_run._run_streaming_stdin
    names = f.__code__.co_varnames[:f.__code__.co_argcount]
    defaults = dict(zip(names[-len(f.__defaults__):], f.__defaults__))
    defaults["chunk_bytes"] = CHUNK
    monkeypatch.setattr(f, "__defaults__", tuple(defaults.values()))


def _run(cell, capsys, image_bytes=1 << 20):
    traffic = small_traffic(run.Cell(BENCH, cell).traffic, image_bytes)
    rc = run.main(["--workload", cell, "--seed", str(2**32 + 9),
                   "--seconds", "0.01"], device="cpu", traffic=traffic)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _wrap_scan(monkeypatch, change):
    plain = native.native_scan

    def scan(*a, **kw):
        res, sb = plain(*a, **kw)
        return change(res, sb, kw)

    monkeypatch.setattr(native, "native_scan", scan)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, capsys):
    got = _run(cell, capsys)
    assert got["correct"] and got["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in got["check"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_answer_altered_where_it_is_produced(cell, capsys, monkeypatch):
    def shift(res, sb, kw):
        res = dict(res, position=res["position"] + np.uint64(1))
        return res, sb

    _wrap_scan(monkeypatch, shift)
    got = _run(cell, capsys)
    assert not got["correct"] and got["failed"] == got["attempted"]
    assert got["check"]["region_lines_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_half_of_the_findings_left_out(cell, capsys, monkeypatch):
    def halve(res, sb, kw):
        return {k: v[::2] for k, v in res.items()}, sb

    _wrap_scan(monkeypatch, halve)
    got = _run(cell, capsys)
    assert not got["correct"]
    assert got["check"]["region_lines_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", STREAMED)
def test_a_chunk_that_returns_its_state_unchanged(cell, capsys, monkeypatch):
    plain = native.native_scan

    def scan(*a, **kw):
        st = kw.get("state")
        before = copy.deepcopy(st)
        out = plain(*a, **kw)
        if st is not None:
            st.clear()
            st.update(before)
        return out

    monkeypatch.setattr(native, "native_scan", scan)
    got = _run(cell, capsys)
    assert not got["correct"]


SAMPLED_EVERY_CHUNK = [n for n in CELLS if run.Cell(BENCH, n).traffic[
    "check"].get("marks_each_seam")]


@pytest.mark.parametrize("cell", SAMPLED_EVERY_CHUNK)
def test_the_findings_of_one_chunk_left_out(cell, capsys, monkeypatch):
    """Every finding of the image's second chunk dropped where it is
    produced, with the frame, the grammar and the order of the stream
    whole: the regions that the mix draws in every chunk catch it."""
    def drop(res, sb, kw):
        pos = res["position"]
        keep = (pos < CHUNK) | (pos >= 2 * CHUNK)
        return {k: v[keep] for k, v in res.items()}, sb

    _wrap_scan(monkeypatch, drop)
    got = _run(cell, capsys)
    assert not got["correct"]
    assert got["check"]["region_lines_wrong"]["value"] > 0
    for name in ("frame_errors", "grammar_errors", "order_errors"):
        assert got["check"][name]["value"] == 0
