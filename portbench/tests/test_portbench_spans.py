"""The per-layer metrics that read the port's feed, emitter and chunk-loop
spans and its counters: each reads a synthetic context, or synthetic
counters in `stringsext_tpu_torch.utils.profiling`, to a known value, and
reads nothing (None) where its span or counter is absent, as on a program
that has none."""

from collections import defaultdict

import pytest

from portbench import run
from stringsext_tpu_torch.utils import profiling

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
SPAN_METRICS = {"feed.lanes.ms_per_GB": "feed.lanes",
                "feed.join.ms_per_GB": "feed.join",
                "feed.fetch.ms_per_GB": "feed.fetch",
                "feed.ranges.ms_per_GB": "feed.ranges",
                "chunk.read_wait.ms_per_GB": "chunk.read_wait"}
COUNTER_METRICS = ["card.to_card_bytes_per_byte", "card.syncs_per_GB",
                   "feed.shared_pct"]


def _ctx(scopes, gb=2.0, mode="streamed"):
    ctx = run.MetricContext.__new__(run.MetricContext)
    ctx.scopes, ctx.gb, ctx.traffic = scopes, gb, {"mode": mode}
    return ctx


@pytest.fixture
def counts(monkeypatch):
    c = defaultdict(int)
    monkeypatch.setattr(profiling, "_counts", c)
    return c


@pytest.mark.parametrize("metric, scope", sorted(SPAN_METRICS.items()))
def test_span_metric_reads_its_scope(metric, scope):
    read = run.metric_reader(metric)
    assert read(_ctx({scope: 0.5, "device.feed": 9.0})) == 250.0
    assert read(_ctx({"device.feed": 9.0})) is None


def test_read_wait_only_where_the_scan_streams():
    read = run.metric_reader("chunk.read_wait.ms_per_GB")
    assert read(_ctx({"chunk.read_wait": 0.5}, mode="buffered")) is None


def test_emit_mission_max_reads_the_slowest_mission():
    read = run.metric_reader("emit.mission_max.ms_per_GB")
    scopes = {"host.emit": 3.0, "host.emit.0": 0.5, "host.emit.1": 1.5,
              "host.emit.12": 1.0, "host.emit.x": 7.0}
    assert read(_ctx(scopes)) == 750.0
    assert read(_ctx({"host.emit": 3.0})) is None


def test_to_card_bytes_per_byte(counts):
    read = run.metric_reader("card.to_card_bytes_per_byte")
    assert read(None) is None
    counts.update({"bytes.scanned": 1000, "bytes.to_card": 4000})
    assert read(None) == 4.0
    del counts["bytes.to_card"]
    assert read(None) is None


def test_syncs_per_gb(counts):
    read = run.metric_reader("card.syncs_per_GB")
    counts["card.syncs"] = 26
    assert read(None) is None  # nothing scanned
    counts["bytes.scanned"] = 67_108_864
    assert read(None) == pytest.approx(26 / 0.067108864, rel=1e-12)


def test_shared_pct_reads_the_share_of_pieces_on_the_shared_upload(counts):
    read = run.metric_reader("feed.shared_pct")
    assert read(None) is None  # no piece fed
    counts["feed.pieces"] = 40
    assert read(None) == 0.0  # every piece copied its own bytes
    counts["feed.shared_pieces"] = 40
    assert read(None) == 100.0
    counts["feed.shared_pieces"] = 30
    assert read(None) == 75.0


def test_shared_pct_is_listed_on_every_cell_that_feeds():
    entry = {m["name"]: m for m in BENCH["per_layer"]}["feed.shared_pct"]
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["layer"] == "run-table feed"
    assert entry["workloads"] == ["trio.dense64", "trio.sparse512_stream",
                                  "allenc.sweep128_stream"]


@pytest.mark.parametrize("metric", COUNTER_METRICS)
def test_counter_metric_reads_nothing_without_counters(metric, monkeypatch):
    monkeypatch.delattr(profiling, "_counts")
    assert run.metric_reader(metric)(None) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS) + COUNTER_METRICS
                         + ["emit.mission_max.ms_per_GB"])
def test_each_metric_has_its_entry(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert entry["moves"] == "scan_GBps"
    assert entry["source"] == ("program_counter" if metric in COUNTER_METRICS
                               else "program_span")
