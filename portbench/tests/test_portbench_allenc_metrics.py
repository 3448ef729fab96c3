"""The cell `allenc.sweep128_stream` and the readers of the chain kinds'
spans and counters. The readers (`feed.chain` and `feed.chain.wait` in
ms a GB, the share of chain pieces whose orbit ran on the card's kernel,
the share of ISO-2022-JP's pieces whose last-set scans did, and the
orbit kernel's roofline over the sweep's seven chain missions) are held
on a hand-made `MetricContext` or synthetic counters, and read nothing
(None) where the port has no such span or counter, as a program without
them. The cell is listed, by name, on the streamed path's per-layer
metrics and on the chain path's, and its configuration's flags are
`--list-encodings` less `replacement`."""

from collections import defaultdict

import pytest

from portbench import run
from stringsext_tpu_torch import cli, help
from stringsext_tpu_torch.utils import profiling

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
CELL = "allenc.sweep128_stream"
# the per-layer metrics of the streamed path (`trio.sparse512_stream`'s
# but the report clamp's share, whose entry names its cells)
STREAMED = {"feed.ms_per_GB", "assemble.ms_per_GB",
            "stream_residual.ms_per_GB", "merge.ms_per_GB",
            "device.idle_pct", "feed.lanes.ms_per_GB",
            "feed.fetch.ms_per_GB", "feed.ranges.ms_per_GB",
            "emit.mission_max.ms_per_GB", "chunk.read_wait.ms_per_GB",
            "card.to_card_bytes_per_byte", "card.syncs_per_GB",
            "feed.join.ms_per_GB", "feed.shared_pct"}
# the chain path's, listed on this cell alone: (unit, source)
CHAIN = {"feed.chain.ms_per_GB": ("ms/GB", "program_span"),
         "feed.chain.wait.ms_per_GB": ("ms/GB", "program_span"),
         "feed.chain.orbit_kernel_pct": ("%", "program_counter"),
         "feed.chain.iso_kernel_pct": ("%", "program_counter")}
MIB128 = 128 << 20
KERNEL = "orbit_kernel(int const*, long, long, long, int*, bool*)"


def _ctx(scopes=None, nbytes=4e9, device=None):
    events = None if device is None else {
        "device": device, "host": [], "span": (0.0, 1e7)}
    return run.MetricContext(run.Cell(BENCH, CELL), scopes or {}, nbytes,
                             events, MIB128, [0])


@pytest.fixture
def counts(monkeypatch):
    c = defaultdict(int)
    monkeypatch.setattr(profiling, "_counts", c)
    return c


@pytest.mark.parametrize("name,scope", [
    ("feed.chain.ms_per_GB", "feed.chain"),
    ("feed.chain.wait.ms_per_GB", "feed.chain.wait"),
])
def test_span_metrics_read_their_scope(name, scope):
    read = run.metric_reader(name)
    assert read(_ctx({scope: 2.0, "feed.lanes": 9.0})) == pytest.approx(500.0)
    assert read(_ctx({"feed.lanes": 9.0})) is None  # the parent's program
    assert read(_ctx({scope: 2.0}, nbytes=0)) is None


def test_orbit_kernel_pct_reads_the_share_of_chain_pieces(counts):
    read = run.metric_reader("feed.chain.orbit_kernel_pct")
    assert read(None) is None  # no chain piece counted: the parent
    counts["feed.chain.pieces"] = 112
    assert read(None) == 0.0  # every orbit off the card: the CPU
    counts["feed.chain.orbit_kernel"] = 112
    assert read(None) == 100.0
    counts["feed.chain.orbit_kernel"] = 28
    assert read(None) == 25.0


def test_orbit_kernel_pct_reads_nothing_without_counters(monkeypatch):
    monkeypatch.delattr(profiling, "_counts")
    assert run.metric_reader("feed.chain.orbit_kernel_pct")(None) is None


def test_iso_kernel_pct_reads_the_share_of_iso_pieces(counts):
    read = run.metric_reader("feed.chain.iso_kernel_pct")
    counts["feed.chain.pieces"] = 112  # the CJK kinds' pieces count here
    assert read(None) is None  # no ISO-2022-JP piece fed
    counts["feed.chain.iso_pieces"] = 16
    assert read(None) == 0.0  # every last-set scan off the card: the CPU
    counts["iso.scan.kernel"] = 16
    assert read(None) == 100.0
    counts["iso.scan.kernel"] = 4
    assert read(None) == 25.0


def test_iso_kernel_pct_reads_nothing_without_counters(monkeypatch):
    monkeypatch.delattr(profiling, "_counts")
    assert run.metric_reader("feed.chain.iso_kernel_pct")(None) is None


@pytest.mark.parametrize("name", sorted(CHAIN))
def test_chain_entry(name):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[name]
    unit, source = CHAIN[name]
    assert (entry["unit"], entry["source"]) == (unit, source)
    assert entry["better"] == ("lower" if unit == "ms/GB" else "higher")
    assert entry["layer"] == "run-table feed"
    assert entry["moves"] == "scan_GBps" and entry["workloads"] == [CELL]


def test_orbit_roofline_over_seven_chain_missions_at_128_mib():
    """7 chain missions x 5 B a position x 134,217,728 B over 3.35 TB/s:
    1.4023 ms, against 112 launches (7 missions x 16 chunks) of 25 us."""
    read = run.metric_reader("orbit_roofline")
    bound = 7 * 5 * MIB128 / 3.35e12
    assert 7 * 5 * MIB128 == 4_697_620_480
    assert bound == pytest.approx(1.40227e-3, rel=1e-5)
    device = [(0, KERNEL, 100.0 * k, 100.0 * k + 25.0) for k in range(112)]
    device.append((0, "report_clamp_kernel", 0.0, 5e5))
    got = read(_ctx(device=device))
    assert got == pytest.approx(100 * bound / (112 * 25e-6))
    assert 50.0 < got < 50.1
    assert read(_ctx(device=device[-1:])) is None  # no orbit kernel ran
    assert read(_ctx()) is None  # no trace


def test_the_cell_reports_the_streamed_path_metrics():
    """Entries found by name, not by place: the cell is listed on every
    per-layer metric of the streamed path and of the chain path that
    reads something in it."""
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["config"] == "allenc" and cells[CELL]["chips"] == 1
    listed = {m["name"] for m in BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed >= STREAMED | set(CHAIN)
    cell = run.Cell(BENCH, CELL)
    assert {m["name"] for m in cell.per_layer} == listed
    assert all(m["moves"] == "scan_GBps" for m in cell.per_layer)
    assert {m["name"] for m in cell.end_to_end} == {
        "scan_GBps", "peak_device_GiB", "setup_s"}


def test_the_configuration_is_the_encoding_list_less_replacement(capsys):
    assert help.help_and_maybe_exit(cli.parse_args(["--list-encodings"]))
    text = capsys.readouterr().out
    listed = text.split("ENC_NAME (Encoding)=\n")[1].split(
        "\tWarning")[0].split()
    assert len(listed) == 41 and "replacement" in listed
    want = ["-t", "x"]
    for name in listed:
        if name != "replacement":
            want += ["-e", name]
    assert run.Cell(BENCH, CELL).config["argv"] == want
