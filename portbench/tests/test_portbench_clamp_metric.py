"""`feed.clamp_kernel_pct`: the share of the feed's pieces whose report
clamp ran on the card's kernel, from the port's counters `feed.pieces`
and `feed.clamp.kernel`; nothing (None) where the port counts no piece,
as a program without the counters."""

from collections import defaultdict

import pytest

from portbench import run
from stringsext_tpu_torch.utils import profiling

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
METRIC = "feed.clamp_kernel_pct"


@pytest.fixture
def counts(monkeypatch):
    c = defaultdict(int)
    monkeypatch.setattr(profiling, "_counts", c)
    return c


def test_reads_the_share_of_pieces_the_kernel_clamped(counts):
    read = run.metric_reader(METRIC)
    assert read(None) is None  # no piece counted: the parent's program
    counts["feed.pieces"] = 8
    assert read(None) == 0.0  # every piece clamped off the card
    counts["feed.clamp.kernel"] = 8
    assert read(None) == 100.0
    counts["feed.clamp.kernel"] = 2
    assert read(None) == 25.0


def test_reads_nothing_without_counters(monkeypatch):
    monkeypatch.delattr(profiling, "_counts")
    assert run.metric_reader(METRIC)(None) is None


def test_entry():
    entry = {m["name"]: m for m in BENCH["per_layer"]}[METRIC]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "scan_GBps" and entry["unit"] == "%"
    assert entry["workloads"] == ["trio.dense64", "trio.sparse512_stream"]
    assert [m["name"] for m in BENCH["per_layer"]].count(METRIC) == 1
