"""The port's tracing, `stringsext_tpu_torch.utils.profiling`: scopes that
are also `torch.profiler` spans, counters, `enable()` after import, and
tables that threads share.

Scans run the trio (`-t x -e UTF-8 -e UTF-16LE -e UTF-16BE`) through
`run.run(..., device="cpu")`, buffered and streamed, at small sizes, and
two chain kinds (`-u Asian -e Shift_JIS -e ISO-2022-JP`) for the chain path's
spans `feed.chain` and `feed.chain.wait`. The counters' expected values
follow from the code:

- buffered, n bytes (under the hot map's 32 MiB pass and the feed's
  64 MiB piece): the hot map copies the n bytes to the card in one pass
  and waits once (`hot.cpu()`); each of the three missions' feed copies
  the piece, n bytes (its halo is clipped at both ends of the stream),
  and waits 8 times: `_fetch` of the feedable chars (`nonzero`, the
  positions and two gathered lanes back), `int(last)` (the report
  clamp's last max), `_fetch` of the extras (`nonzero`, the positions,
  one lane). So `bytes.to_card` is 4n and `card.syncs` 1 + 3 * 8 = 25,
  every mission's hot map is computed and replaced by its feed's ranges,
  and `feed.pieces` is 3, one piece a mission, none clamped by the
  card's kernel (`feed.clamp.kernel` absent) on the CPU.
- streamed in c-byte chunks, over an image of zeros with strings of the
  three encodings inside every chunk: each mission's decoder consumes
  every chunk whole, so no bytes carry over and each chunk's feed
  starts at the chunk's first byte. Each chunk copies its bytes once a
  mission and waits 8 times a mission; no mission needs a hot map. So
  `bytes.to_card` is 3 * the image's bytes, `card.syncs` 24 a chunk and
  `feed.pieces` 3 a chunk.
"""

import json
import os
import subprocess
import sys
import threading
from collections import defaultdict

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from stringsext_tpu_torch import cli, run
from stringsext_tpu_torch.corpus import make_corpus
from stringsext_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIO = ["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE", "-e", "UTF-16BE"]
CHAIN = ["-t", "x", "-u", "Asian", "-e", "Shift_JIS", "-e", "ISO-2022-JP"]
CHUNK = 64 * 1024
NEW_SPANS = {"feed.lanes", "feed.fetch", "feed.join", "feed.ranges",
             "host.emit.0", "host.emit.1", "host.emit.2"}
STREAM_SPANS = {"chunk.read_wait", "chunk.holdback"}


@pytest.fixture
def tables(monkeypatch):
    """Fresh, empty tables, tracing off; both restored afterwards."""
    monkeypatch.setattr(profiling, "ENABLED", False)
    monkeypatch.setattr(profiling, "_stats",
                        defaultdict(lambda: [0.0, 0, 0]))
    monkeypatch.setattr(profiling, "_counts", defaultdict(int))
    return profiling


def _sparse_image(chunks: int, tail: int) -> bytes:
    """Zeros, with a UTF-8, a UTF-16LE and a UTF-16BE string at even
    offsets inside every chunk, away from its seams."""
    data = bytearray(chunks * CHUNK + tail)
    words = ["plain utf8 finding", "wide utf16le finding",
             "wide utf16be finding"]
    for k in range(chunks + (1 if tail else 0)):
        at = k * CHUNK + 1024
        for enc, w in zip(("utf-8", "utf-16-le", "utf-16-be"), words):
            b = w.encode(enc)
            data[at:at + len(b)] = b
            at += 512
    return bytes(data)


def _small_chunks(monkeypatch):
    real = run._run_streaming_stdin

    def chunked(*a, **k):
        k["chunk_bytes"] = CHUNK
        return real(*a, **k)

    monkeypatch.setattr(run, "_run_streaming_stdin", chunked)


def _chain_image() -> bytes:
    """64 KiB of zeros holding Shift_JIS and ISO-2022-JP text."""
    data = bytearray(64 * 1024)
    for at, (codec, text) in zip((1024, 9000, 30001, 50002), [
            ("shift_jis", "ファームウェアの更新"), ("iso2022_jp", "設定を保存 OK"),
            ("shift_jis", "ディスクの整合性"), ("iso2022_jp", "カタカナ")]):
        b = text.encode(codec)
        data[at:at + len(b)] = b
    return bytes(data)


def _scan(path, tmp_path, extra=(), argv=TRIO):
    out = tmp_path / "out.txt"
    with open(out, "wb") as f:
        assert run.run(cli.parse_args(argv + list(extra) + ["--", str(path)]),
                       out=f, device="cpu") == 0
    return out.read_bytes()


def _annotations(prof, tmp_path):
    """[(name, thread, start, end)] of the trace's user annotations."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    return [(e["name"], e["tid"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
            for e in doc["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(ann, child, parent):
    """Every `child` span lies inside a `parent` span of its thread."""
    spans = [a for a in ann if a[0] == child]
    assert spans, child
    for _, tid, s, e in spans:
        assert any(p[0] == parent and p[1] == tid and p[2] <= s and e <= p[3]
                   for p in ann), (child, s, e)


@pytest.mark.parametrize("route", ["buffered", "streamed"])
def test_scan_spans_reach_the_profiler_trace(route, tables, tmp_path,
                                             monkeypatch):
    if route == "buffered":
        data, extra = make_corpus(256 * 1024, seed=5).tobytes(), []
        want = NEW_SPANS
    else:
        _small_chunks(monkeypatch)
        data, extra = _sparse_image(3, 20000), ["--stream-file-min", "4096"]
        want = NEW_SPANS | STREAM_SPANS
    path = tmp_path / "in.bin"
    path.write_bytes(data)
    tables.enable()
    # the emitter's spans open on pool threads, which the profiler records
    # only when asked to record every thread
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _scan(path, tmp_path, extra)
    ann = _annotations(prof, tmp_path)
    names = {a[0] for a in ann}
    assert want <= names, want - names
    assert "host.assemble" in names and "device.feed" in names
    for child in ("feed.lanes", "feed.fetch", "feed.join", "host.assemble"):
        _inside(ann, child, "device.feed")
    # the same spans as the scopes' table, call for call
    for name in want:
        assert sum(a[0] == name for a in ann) == tables._stats[name][1], name


def test_buffered_counters_follow_from_the_code(tables, tmp_path):
    n = 256 * 1024
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(n, seed=6).tobytes())
    tables.enable()
    _scan(path, tmp_path)
    assert dict(tables._counts) == {
        "bytes.scanned": n, "bytes.to_card": 4 * n, "card.syncs": 25,
        "hotmap.missions": 3, "hotmap.replaced": 3, "feed.pieces": 3}
    assert "device.lanes_hotmap" not in tables._stats


def test_streamed_counters_follow_from_the_code(tables, tmp_path,
                                                monkeypatch):
    _small_chunks(monkeypatch)
    data = _sparse_image(3, 20000)
    path = tmp_path / "in.bin"
    path.write_bytes(data)
    tables.enable()
    _scan(path, tmp_path, ["--stream-file-min", "4096"])
    chunks = 4
    assert dict(tables._counts) == {
        "bytes.scanned": len(data), "bytes.to_card": 3 * len(data),
        "card.syncs": 24 * chunks, "feed.pieces": 3 * chunks}
    assert tables._stats["chunk.read_wait"][1] == chunks
    assert tables._stats["feed.ranges"][1] == 3 * chunks


def test_off_records_nothing_and_opens_no_span(tables, tmp_path,
                                               monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(64 * 1024, seed=7).tobytes())
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _scan(path, tmp_path)
    assert opened == []
    assert not tables._stats and not tables._counts
    assert not {a[0] for a in _annotations(prof, tmp_path)} & (
        NEW_SPANS | {"device.feed", "host.assemble", "scan"})


def test_chain_spans_nest_in_the_lanes_span(tables, tmp_path):
    """Buffered, each chain mission feeds one piece: one `feed.chain` span
    inside `feed.lanes`, holding one wait for the next entry and, for
    ISO-2022-JP, one more for its state transfer."""
    path = tmp_path / "in.bin"
    path.write_bytes(_chain_image())
    tables.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _scan(path, tmp_path, argv=CHAIN)
    assert got.count("ファームウェア".encode()) == 1
    assert got.count("設定を保存".encode()) == 1
    ann = _annotations(prof, tmp_path)
    _inside(ann, "feed.chain", "feed.lanes")
    _inside(ann, "feed.chain.wait", "feed.chain")
    assert sum(a[0] == "feed.chain" for a in ann) == 2
    assert sum(a[0] == "feed.chain.wait" for a in ann) == 3
    assert tables._counts["feed.chain.pieces"] == 2
    assert tables._counts["feed.chain.orbit_kernel"] == 0


def test_off_opens_no_chain_span(tables, tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    path = tmp_path / "in.bin"
    path.write_bytes(_chain_image())
    _scan(path, tmp_path, argv=CHAIN)
    assert opened == []
    assert not tables._stats and not tables._counts


def test_enable_after_import_takes_effect(tables, capsys):
    with tables.scope("off"):
        pass
    tables.count("off")
    tables.enable()
    with tables.scope("on", 10):
        pass
    tables.count("on", 3)
    tables.enable(False)
    with tables.scope("off again"):
        pass
    assert set(tables._stats) == {"on"} and tables._stats["on"][1:] == [1, 10]
    assert dict(tables._counts) == {"on": 3}
    tables.enable()
    tables.report()
    lines = capsys.readouterr().err.splitlines()
    assert lines[0] == "--- stringsext-tpu profile ---"
    assert lines[1].startswith("on ") and lines[2].split() == ["on", "3"]


def test_threads_lose_no_update(tables):
    """Eight threads, 1,000 spans and counts each, with the interpreter
    switching threads as often as it can: the totals are exact."""
    tables.enable()
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=60)
        for _ in range(1000):
            with tables.scope("span", 2):
                tables.count("count")
            tables.count("bytes", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tables._stats["span"][1:] == [8000, 16000]
    assert dict(tables._counts) == {"count": 8000, "bytes": 24000}


def test_spans_import_no_torch_on_a_host_route(tmp_path):
    """With torch blocked, an enabled scan of the host route times its
    scopes, counts its bytes and never imports torch."""
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(64 * 1024, seed=8).tobytes())
    prog = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from stringsext_tpu_torch import cli\n"
        "from stringsext_tpu_torch.utils import profiling\n"
        "profiling.enable()\n"
        "code = cli.main(['--engine', 'auto'] + sys.argv[1:])\n"
        "assert 'torch' not in sys.modules\n"
        "sys.exit(code)\n")
    r = subprocess.run(
        [sys.executable, "-c", prog] + TRIO + ["-p", str(tmp_path / "o"),
                                               str(path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, STRINGSEXT_DEVICE_PROBE="0"))
    assert r.returncode == 0, r.stderr
    assert "host.emit.0" in r.stderr
    assert f"bytes.scanned                    {64 * 1024}" in r.stderr
    assert "bytes.to_card" not in r.stderr


def test_report_is_silent_when_off(tables, capsys):
    tables._counts["x"] = 1
    tables.report()
    assert capsys.readouterr().err == ""
