"""The stateful encodings (CJK, ISO-2022-JP, replacement) and every other
of the 41 on the port's hot-map path, buffered and streamed, against the
reference: the cases of tests/test_cjk_hot.py, the sweep of
tests/test_all_encodings_diff.py, the golden pins through stdin, the
segment splitters with their CJK alignment proof and ISO-2022-JP entry
modes, and the routing where the port must do as the reference does
(`cjk_hot_spec` in `scan_arrays`, a mission without a device kernel,
`runtable_feed` outside its kinds) or refuse (`--host-hotmap`). Inputs come from numpy seeds; every comparison is of
bytes or integer arrays (tolerance 0)."""

import io
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from golden_extra import CASES as EXTRA_CASES
from golden_extra import corpus_main
from test_golden_ref import CASES as REF_CASES

import stringsext_tpu.run as ref_run
from stringsext_tpu.cli import parse_args as ref_parse_args
from stringsext_tpu.encodings import ALL_ENCODING_NAMES
from stringsext_tpu.engine import align as ref_align
from stringsext_tpu.input import LoadedStream as RefLoadedStream
from stringsext_tpu.input import slice_table as ref_slice_table
from stringsext_tpu.mission import Missions as RefMissions
from stringsext_tpu_torch import cli
from stringsext_tpu_torch import run as port
from stringsext_tpu_torch.cli import parse_args
from stringsext_tpu_torch.encodings import encoding_kind
from stringsext_tpu_torch.engine import align
from stringsext_tpu_torch.input import LoadedStream, slice_table
from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import device_events, swar
from stringsext_tpu_torch.utils import profiling

# One thread for torch's CPU ops: the inputs are small, and the test run's
# workers together already use every core.
torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "golden_extra")
STATEFUL_KINDS = ("euc-kr", "big5", "shift_jis", "euc-jp", "gb18030",
                  "iso-2022-jp", "replacement")

CJK = [
    ("euc-kr", "euc-kr", "안녕하세요 세계의 문자열"),
    ("shift_jis", "Shift_JIS", "こんにちは世界のテスト"),
    ("euc_jp", "EUC-JP", "日本語のテキスト標本"),
    ("gb18030", "gb18030", "你好世界示例字符串\U00020000"),
    ("gb18030", "GBK", "你好世界示例字符串"),
    ("big5", "Big5", "繁體中文測試字串"),
    ("iso2022_jp", "ISO-2022-JP", "mode 日本語 switch ascii 漢字"),
]


def _sparse_corpus(codec, text, seed, size=96 * 1024):
    """tests/test_cjk_hot.py's corpus: mostly zeros, random islands,
    chain-byte noise that ends at block boundaries, and planted strings
    beside cold spans and inside noise."""
    rng = np.random.default_rng(seed)
    data = bytearray(size)
    t = text.encode(codec)
    for off in (3, 5000, 40960 - len(t) // 2, 70001):
        data[off:off + len(t)] = t
    for off, ln in ((9800, 500), (20480 - 37, 37), (51200, 2048)):
        data[off:off + ln] = rng.integers(0x81, 0xFF, ln, np.uint8).tobytes()
    for off in (30000, 60000):
        data[off:off + 256] = rng.integers(0, 256, 256, np.uint8).tobytes()
    return bytes(data)


def _port(argv, device="cpu"):
    buf = io.BytesIO()
    assert port.run(parse_args(argv), out=buf, device=device) == 0
    return buf.getvalue()


def _port_stream(argv, blob, chunk=8192):
    args = parse_args(argv + ["-"])
    buf = io.BytesIO()
    assert port._run_streaming_stdin(args, Missions.from_args(args), buf,
                                     src=io.BytesIO(blob), chunk_bytes=chunk,
                                     device="cpu") == 0
    return buf.getvalue()


def _ref(argv, engine="auto"):
    buf = io.BytesIO()
    assert ref_run.run(ref_parse_args(argv), out=buf, engine=engine) == 0
    return buf.getvalue()


@pytest.fixture(autouse=True)
def _no_probe(monkeypatch):
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")


@pytest.fixture(params=["1", "0"], ids=["feed-on", "feed-off"])
def feed(request, monkeypatch):
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", request.param)
    return request.param


# ------------------------------------------- the cases of test_cjk_hot.py


@pytest.mark.parametrize("codec,enc,text", CJK, ids=[c[1] for c in CJK])
@pytest.mark.parametrize("ubf", [None, "All", "Asian"])
def test_cjk_scan_equals_the_reference(codec, enc, text, ubf, tmp_path,
                                       monkeypatch):
    """The feed (on by default) against the reference's whole-stream
    scan, and, without a filter, the hot map (and 4 segments, feed off)
    against its engine=tpu; buffered and streamed."""
    monkeypatch.setattr(port, "_SEGMENT_MAX", 4)
    blob = _sparse_corpus(codec, text, seed=len(enc) * 7 + len(text))
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", enc] + (["-u", ubf] if ubf else [])
    got = _port(argv + [str(p)])
    assert got == _ref(argv + [str(p)], "auto")
    if ubf != "All":  # "All" resolves to All-Asian: nothing of the text
        assert got.count(b"\n") >= 4, got
    if ubf is None:
        monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")
        assert got == _ref(argv + [str(p)], "tpu")
    for chunk in (4096, 65536):
        assert _port_stream(argv, blob, chunk) == got, chunk


@pytest.mark.parametrize("cold", [b"\xfe", b"\x00", b"\x0e"])
@pytest.mark.parametrize("gap", [1, 128, 129, 4096])
def test_iso2022_output_flag_across_cold_spans(cold, gap, tmp_path):
    """A second escape after a cold span still reports its error: the
    emitter must not skip a window while the output flag is set."""
    head = b"JIS text: \x1b$B" + "日本".encode("iso2022_jp")[3:-3]
    for k, mid in enumerate((cold * gap, b"\x1b(B" + cold * gap)):
        data = (b"\x00" * 700 + head + mid + b"\x1b$B"
                + "漢字".encode("iso2022_jp")[3:-3] + b"\x1b(B tail ascii str"
                + b"\x00" * 3000)
        p = tmp_path / f"in{k}.bin"
        p.write_bytes(data)
        argv = ["-t", "x", "-e", "ISO-2022-JP", "-u", "Asian"]
        got = _port(argv + [str(p)])
        assert got == _ref(argv + [str(p)], "auto"), (cold, gap, k)
        assert _port_stream(argv, data, 4096) == got


# ------------------------------------- the sweep of test_all_encodings_diff


def _mixed_corpus():
    rng = np.random.default_rng(99)
    blob = bytearray(rng.integers(0, 256, 131072, np.uint8).tobytes())
    blob[9000:17000] = b"\x00" * 8000
    plants = [
        ("utf-8", "déjà €uro мир 汉字"), ("utf-16-le", "wide строка"),
        ("cp932", "日本語テスト"), ("gb18030", "中文测试\U00020000"),
        ("cp949", "한국어"), ("big5", "中文字元"), ("iso2022_jp", "日本語"),
        ("koi8_r", "Русский текст КОИ8"), ("cp1252", "Latin-1 naïve café"),
    ]
    off = 20000
    for codec, text in plants:
        t = text.encode(codec, errors="ignore")
        blob[off:off + len(t)] = t
        off += len(t) + 777
    return bytes(blob)


@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("stateful") / "mix.bin"
    p.write_bytes(_mixed_corpus())
    return str(p)


ALL_41 = ["ascii"] + list(ALL_ENCODING_NAMES)


@pytest.mark.parametrize("enc", ALL_41)
def test_every_encoding_equals_the_reference(enc, mixed_file):
    """One mission at a time, buffered and streamed, against the
    reference's engine=auto."""
    argv = ["-t", "x", "-n", "5", "-e", enc]
    want = _ref(argv + [mixed_file])
    assert _port(argv + [mixed_file]) == want, enc
    assert _port_stream(argv, _mixed_corpus(), 65536) == want, enc


def _fresh_tables(monkeypatch):
    """Profiling on, with empty tables; restored afterwards."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    monkeypatch.setattr(profiling, "_stats",
                        defaultdict(lambda: [0.0, 0, 0]))
    monkeypatch.setattr(profiling, "_counts", defaultdict(int))


def test_all_41_encodings_in_one_scan(mixed_file, monkeypatch):
    """The whole sweep as one mission set: one `swar_counts` call serves
    every spec of a chunk (feed off); with the feed on, streamed, only
    the missions without a feed ask it (replacement, whose kind has none,
    and ISO-2022-JP in a chunk entered out of its ground state).

    With the feed on, the chain kinds' counters and spans: each of the
    seven chain missions (Big5, EUC-JP, EUC-KR, GBK, gb18030, Shift_JIS,
    ISO-2022-JP) feeds one piece a scan buffered and one a chunk
    streamed, but ISO-2022-JP skips the chunks it enters out of its
    ground state; a piece waits once for its next entry and an
    ISO-2022-JP piece once more for its state transfer; on the CPU no
    orbit runs on the card's kernel."""
    argv = ["-t", "x", "-n", "6"] + [a for e in ALL_41 for a in ("-e", e)]
    want = _ref(argv + [mixed_file])
    assert want.count(b"\n") > 400
    real = swar.swar_counts
    chain = 7

    def chain_counts(pieces, iso_pieces):
        assert profiling._counts["feed.chain.pieces"] == pieces
        assert profiling._counts["feed.chain.orbit_kernel"] == 0
        assert profiling._stats["feed.chain"][1] == pieces
        assert profiling._stats["feed.chain.wait"][1] == pieces + iso_pieces
        _fresh_tables(monkeypatch)

    for feed_env, nspecs in (("0", len(ALL_41)), ("1", None)):
        monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", feed_env)
        _fresh_tables(monkeypatch)
        calls = []

        def spy(w, specs, **kw):
            calls.append(len(specs))
            return real(w, specs, **kw)

        spy.launches = 0  # read by the profile's report
        monkeypatch.setattr(swar, "swar_counts", spy)
        assert _port(argv + [mixed_file]) == want
        assert calls == [len(ALL_41)]  # buffered: one chunk, every mission
        chain_counts(chain if nspecs is None else 0,
                     1 if nspecs is None else 0)
        calls.clear()
        assert _port_stream(argv, _mixed_corpus(), 65536) == want
        stateful = sum(encoding_kind(m.encoding_name) in STATEFUL_KINDS
                       for m in Missions.from_args(parse_args(argv + ["x"])))
        assert stateful == 8
        no_feed = sum(encoding_kind(m.encoding_name)
                      not in device_events.FEED_KINDS
                      for m in Missions.from_args(parse_args(argv + ["x"])))
        assert no_feed == 1
        # streamed: 2 chunks and a last one that holds what they left
        # over, if anything; with the feed on only missions without a
        # feed ask the kernel
        assert len(calls) in (2, 3)
        assert set(calls) <= ({nspecs} if nspecs else {no_feed, no_feed + 1})
        iso_fed = 0 if nspecs else calls.count(no_feed)
        chain_counts(0 if nspecs else (chain - 1) * len(calls) + iso_fed,
                     iso_fed)
        monkeypatch.setattr(swar, "swar_counts", real)


def test_stateful_corpus_streamed_and_buffered(tmp_path, feed):
    """The firmware-like corpus of the card check at 2 MiB, with its
    mission set: sections of zeros, 0xFF, random bytes and string tables
    (some torn), every message found, streamed in 64 KiB chunks and
    buffered equal to the reference."""
    from stringsext_tpu_torch import corpus

    raw = corpus.stateful_corpus(2 << 20, seed=0)
    np.testing.assert_array_equal(raw, corpus.stateful_corpus(2 << 20, 0))
    sec = 256 * 1024
    assert not raw[:sec].any() and (raw[2 * sec:3 * sec] == 0xFF).all()
    assert len(np.unique(raw[5 * sec:6 * sec])) == 256
    p = tmp_path / "fw.bin"
    raw.tofile(p)
    argv = ["-t", "x", "-u", "Asian"] + [a for e in corpus.STATEFUL_ENCODINGS
                                         for a in ("-e", e)]
    got = _port(argv + [str(p)])
    assert got == _ref(argv + [str(p)])
    assert _port_stream(argv, raw.tobytes(), 65536) == got
    for _codec, text in corpus.STATEFUL_MESSAGES:
        assert got.count(text[:3].encode()) > 100, text


# ----------------------------------------------- goldens through stdin


@pytest.mark.parametrize("name,extra,data,want", REF_CASES,
                         ids=[c[0] for c in REF_CASES])
def test_golden_ref_streamed(name, extra, data, want, feed):
    assert _port_stream(["-t", "d"] + extra, data, 4096) == want, name


SINGLE_EXTRA = [c for c in EXTRA_CASES if not c[2]]


@pytest.mark.parametrize("case", SINGLE_EXTRA, ids=[c[0] for c in SINGLE_EXTRA])
def test_golden_extra_streamed(case, feed):
    name, argv, _multi = case
    with open(os.path.join(GOLD, f"{name}.bin"), "rb") as f:
        want = f.read()
    for chunk in (4096, 65536):
        assert _port_stream(argv, corpus_main(), chunk) == want, (name, chunk)


# ------------------------------------------------------ segment splitters


def _seg_inputs(codec, enc, text, missions, loaded, table):
    blob = _sparse_corpus(codec, text, seed=11, size=256 * 1024)
    data = np.frombuffer(blob, np.uint8)
    m = missions.new(flag_encoding=[enc]).v[0]
    sl = table(loaded(data, [(1, 0, len(data))]))
    return data, m, sl


@pytest.mark.parametrize("codec,enc,text", CJK, ids=[c[1] for c in CJK])
def test_segment_rows_equal_the_reference(codec, enc, text):
    """`_segment_rows` (hot map) with the CJK alignment proof and
    `_probe_segment_rows` (no hot map), for 2-8 segments."""
    data, m, sl = _seg_inputs(codec, enc, text, Missions, LoadedStream,
                              slice_table)
    _d, rm, rsl = _seg_inputs(codec, enc, text, RefMissions, RefLoadedStream,
                              ref_slice_table)
    kind = encoding_kind(m.encoding_name)
    spec = port.swar_mission_spec(m) or port.cjk_hot_spec(m)
    hot = port.device_hot_ranges_swar(
        LoadedStream(data, [(1, 0, len(data))]), [(0, spec)],
        torch.device("cpu"))[0]
    window = 2 * m.output_line_char_nb_max
    seen = set()
    for max_seg in (2, 3, 4, 8):
        got = port._segment_rows(sl, hot, window, max_seg, data=data,
                                 kind=kind)
        assert got == ref_run._segment_rows(rsl, hot, window, max_seg,
                                            data=data, kind=kind)
        probed = port._probe_segment_rows(data, sl, m, kind, window, max_seg)
        assert probed == ref_run._probe_segment_rows(data, rsl, rm, kind,
                                                     window, max_seg)
        seen.update(got, probed)
        if kind == "iso-2022-jp" and got:
            bounds = [0] + got + [len(sl[0])]
            for kw in ({}, {"initial_mode": 3, "first_lo": 2}):
                assert port._iso_entry_modes(data, sl, bounds, **kw) == \
                    ref_run._iso_entry_modes(data, rsl, bounds, **kw)
    assert seen, "no split point found: the corpus has cold spans"
    lut, rlut = port._mission_cold_lut(m), ref_run._mission_cold_lut(rm)
    assert lut[0] == rlut[0] == "lut"
    np.testing.assert_array_equal(lut[1], rlut[1])


def test_iso_entry_modes_follow_the_escapes():
    blob = bytearray(8 * 4096)
    blob[100:103] = b"\x1b$B"  # jis0208
    blob[2 * 4096 + 5:2 * 4096 + 8] = b"\x1b(J"  # Roman
    blob[5 * 4096:5 * 4096 + 3] = b"\x1b(I"  # katakana
    blob[7 * 4096 + 9:7 * 4096 + 12] = b"\x1b(B"  # ASCII
    data = np.frombuffer(bytes(blob), np.uint8)
    sl = slice_table(LoadedStream(data, [(1, 0, len(data))]))
    bounds = [0, 1, 3, 6, 8]
    assert port._iso_entry_modes(data, sl, bounds) == [0, 3, 1, 2]
    assert ref_run._iso_entry_modes(data, sl, bounds) == [0, 3, 1, 2]
    assert port._iso_entry_modes(data, sl, bounds, initial_mode=2,
                                 first_lo=200) == [2, 2, 1, 2]


@pytest.mark.parametrize("kind,codec,text", [
    ("shift_jis", "shift_jis", "こんにちは世界"), ("euc-kr", "euc-kr", "안녕하세요"),
    ("gb18030", "gb18030", "你好世界\U00020000"), ("big5", "big5", "繁體中文"),
    ("euc-jp", "euc_jp", "日本語のテキスト"),
])
def test_align_equals_the_reference(kind, codec, text):
    """`engine/align.py`: the alignment proof at every offset of a text
    between ground bytes, and the mode transfer and its fold."""
    t = text.encode(codec)
    win = np.frombuffer(b"\x00" * 50 + t * 3 + b"  tail\x00" * 4, np.uint8)
    verdicts = []
    for w_lo in (0, 1000):
        for p in range(w_lo + 40, w_lo + 60 + 2 * len(t)):
            got = align._cjk_boundary_aligned(win, w_lo, p, kind)
            assert got == ref_align._cjk_boundary_aligned(win, w_lo, p, kind)
            verdicts.append(got)
    assert True in verdicts and False in verdicts
    rng = np.random.default_rng(3)
    for _ in range(40):
        span = rng.choice(np.frombuffer(b"\x1b$(BJI@A\x00", np.uint8),
                          rng.integers(0, 40))
        assert align._iso_mode_transfer(span) == \
            ref_align._iso_mode_transfer(span)
    assert align._iso_mode_transfer(np.frombuffer(b"ab\x1b$Bcd\x1b(",
                                                  np.uint8)) == 3
    for ts in ([], [-1, 2, -1], [3, -1, 0, 1]):
        for upto in range(len(ts) + 1):
            assert align._compose_entry_mode(ts, upto) == \
                ref_align._compose_entry_mode(ts, upto)


# ------------------------------------------------------------- routing


def _spy_hot_maps(monkeypatch):
    """Count `swar_counts` calls of the scan; the lanes fallback raises."""
    calls = []
    real = swar.swar_counts
    monkeypatch.setattr(swar, "swar_counts", lambda w, specs, **kw: (
        calls.append(specs), real(w, specs, **kw))[1])

    def no_fallback(*_a, **_k):
        raise AssertionError("entered the lanes fallback")

    monkeypatch.setattr(port, "device_hot_ranges", no_fallback)
    return calls


def test_macintosh_takes_the_swar_counts_hot_map(feed, tmp_path, monkeypatch):
    """Its exact spec overflows 16 intervals, so the reference (and now
    the port) asks `cjk_hot_spec` for the coarsened one."""
    rng = np.random.default_rng(8)
    blob = bytearray(rng.integers(0, 256, 200_000, np.uint8).tobytes())
    blob[50_000:120_000] = b"\x00" * 70_000
    t = "Mac Roman text: café † naïve".encode("mac_roman")
    for off in (100, 60_000, 150_000):
        blob[off:off + len(t)] = t
    p = tmp_path / "mac.bin"
    p.write_bytes(bytes(blob))
    argv = ["-t", "x", "-e", "macintosh", "-a", "0x" + "5" * 32, str(p)]
    m = Missions.from_args(parse_args(argv)).v[0]
    assert port.swar_mission_spec(m) is None
    assert port.cjk_hot_spec(m)[0] == "sbyte"
    want = _ref(argv, "auto")
    host = io.BytesIO()
    assert port.run_host(parse_args(argv), out=host) == 0
    calls = _spy_hot_maps(monkeypatch)
    assert _port(argv) == want == host.getvalue()
    assert len(calls) == 1 and calls[0] == (port.cjk_hot_spec(m),)
    assert _port_stream(argv[:-1], bytes(blob), 65536) == want
    # streamed: 4 chunks; with its feed the mission needs no hot map
    assert len(calls) == (1 if feed == "1" else 5)


def test_a_mission_without_a_device_kernel_is_scanned_whole(tmp_path, capsys,
                                                            monkeypatch):
    """No spec and no lanes: `device_hot_ranges` returns None, the scan
    warns once and the mission runs without a hot map. Such a mission has
    no static spec for the probe either, so it runs unsegmented."""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")
    monkeypatch.setattr(device_events, "compute_lanes", lambda *_a, **_k: None)
    monkeypatch.setattr(port, "_SEGMENT_PROBE_MIN", 4096)
    monkeypatch.setattr(port, "_SEGMENT_MAX", 8)
    blob = _sparse_corpus("utf-8", "no kernel for this filter ", seed=2,
                          size=256 * 1024)
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", "UTF-8", "-e", "UTF-8", "-a", "0x" + "5" * 32,
            str(p)]
    ms = Missions.from_args(parse_args(argv))
    assert port.swar_mission_spec(ms.v[0]) is None
    assert port.cjk_hot_spec(ms.v[0]) is None
    stream = LoadedStream(np.frombuffer(blob, np.uint8), [(1, 0, len(blob))])
    assert port.device_hot_ranges(stream, ms.v[0], torch.device("cpu")) is None
    probed = []
    real = port._probe_segment_rows
    monkeypatch.setattr(port, "_probe_segment_rows", lambda *a: (
        probed.append(real(*a)), probed[-1])[1])
    got = _port(argv)
    err = capsys.readouterr().err
    assert err.count("no kernel for UTF-8") == 1 and "full host scan" in err
    assert got == _ref(argv, "auto") and got.count(b"\n") > 8
    assert probed == [[], []]
    # the streaming path has no lanes fallback at all: the same missions
    # go to the probe there, chunk by chunk
    assert _port_stream(argv[:-1], blob, 131072) == got
    assert probed == [[]] * 6


def test_the_probe_splits_a_mission_without_a_hot_map(tmp_path, capsys,
                                                      monkeypatch):
    """With no hot map but a static spec for the probe (here: the scan is
    denied its specs, the probe keeps its own), missions split at probed
    cold rows, buffered and streamed; ISO-2022-JP segments enter in the
    mode their escape history gives."""
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "0")
    monkeypatch.setattr(port, "swar_mission_spec", lambda m: None)
    monkeypatch.setattr(port, "cjk_hot_spec", lambda m: None)
    monkeypatch.setattr(device_events, "compute_lanes", lambda *_a, **_k: None)
    monkeypatch.setattr(port, "_SEGMENT_PROBE_MIN", 4096)
    monkeypatch.setattr(port, "_SEGMENT_MAX", 12)
    blob = bytearray(_sparse_corpus("shift_jis", "こんにちは世界のテスト", seed=4,
                                    size=256 * 1024))
    jis = "mode 日本語 switch 漢字".encode("iso2022_jp")
    for off in (900, 100_000, 200_000):
        blob[off:off + len(jis)] = jis
    blob[130_000:130_003] = b"\x1b$B"  # left in jis0208 across cold rows
    blob[230_000:230_008] = b"\x30\x6c\x30\x6c\x1b(B "
    blob = bytes(blob)
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", "Shift_JIS", "-e", "ISO-2022-JP", "-e", "UTF-8",
            str(p)]
    probed = []
    real = port._probe_segment_rows
    monkeypatch.setattr(port, "_probe_segment_rows", lambda *a: (
        probed.append(real(*a)), probed[-1])[1])
    modes = []
    real_modes = port._iso_entry_modes
    monkeypatch.setattr(port, "_iso_entry_modes", lambda *a, **k: (
        modes.append(real_modes(*a, **k)), modes[-1])[1])
    got = _port(argv)
    assert capsys.readouterr().err.count("full host scan") == 3
    assert got == _ref(argv, "auto") and got.count(b"\n") > 8
    assert len(probed) == 3 and all(len(x) >= 2 for x in probed), probed
    assert len(modes) == 1 and 3 in modes[0]
    probed.clear(), modes.clear()
    assert _port_stream(argv[:-1], blob, 131072) == got
    assert len(probed) == 6 and all(probed), probed
    assert len(modes) == 2 and 3 in modes[1]


def test_runtable_feed_is_none_outside_feed_kinds():
    """The port's FEED_KINDS are the reference's ten; `compute_lanes` (so
    the event backend) stays None for the stateful kinds, as the
    reference's; `runtable_feed` is None for `replacement`."""
    from stringsext_tpu.ops import device_events as ref_device_events

    data = np.frombuffer(_sparse_corpus("shift_jis", "日本語", 1), np.uint8)
    assert device_events.FEED_KINDS == ref_device_events.FEED_KINDS
    assert len(device_events.FEED_KINDS) == 10
    for enc in ("Shift_JIS", "EUC-KR", "gb18030", "Big5", "EUC-JP",
                "ISO-2022-JP", "replacement"):
        assert device_events.compute_lanes(data, enc,
                                           torch.device("cpu")) is None
    m = Missions.new(flag_encoding=["replacement"]).v[0]
    assert device_events.runtable_feed(data, m, torch.device("cpu"),
                                       with_extras=True) is None


@pytest.mark.parametrize("flags,msg", [
    (["--host-hotmap"], "--host-hotmap"),
    (["--mesh", "--host-hotmap"], "--host-hotmap"),  # --mesh itself runs
    (["--engine", "auto"], "--engine"),
    (["--dist-nprocs", "2"], "--dist-nprocs"),
    (["--dist-rank", "0"], "--dist-rank"),
    (["--dist-coord", "h:1"], "--dist-coord"),
])
def test_check_slice_refuses_only_these(flags, msg, tmp_path, capsys,
                                        monkeypatch):
    """Every flag passes `check_slice`. --host-hotmap and --engine auto
    run, in the CLI and through `run_host`, and write the reference's
    bytes under the same engine (auto with the probe pinned off; the
    port's default engine, tpu, for --host-hotmap alone). The --dist-*
    flags: alone, --dist-rank and --dist-coord run the single-process
    scan (run_host too); --dist-nprocs 2 fails in the CLI, from stdin
    with the reference's message, and `run_host` (a single-process
    yardstick) refuses it."""
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    p = tmp_path / "in.bin"
    p.write_bytes(b"some text here\x00" * 10)
    args = parse_args(flags + ["-e", "Shift_JIS", str(p)])
    cmd = ["--device", "cpu"] + flags + ["-e", "UTF-8"]
    port.check_slice(args, Missions.from_args(args))  # admitted
    if not msg.startswith("--dist-"):
        engine = "auto" if "auto" in flags else "tpu"
        want = _ref(flags + ["-e", "Shift_JIS", str(p)], engine)
        buf = io.BytesIO()
        assert port.run_host(args, out=buf) == 0 and buf.getvalue() == want
        assert cli.main(cmd + ["-p", str(tmp_path / "o"), str(p)]) == 0
        assert (tmp_path / "o").read_bytes() == _ref(
            flags + ["-e", "UTF-8", str(p)], engine)
        assert capsys.readouterr().err == ""
        return
    if msg != "--dist-nprocs":
        buf = io.BytesIO()
        assert port.run_host(args, out=buf) == 0
        assert buf.getvalue().count(b"some text here") == 10
        assert cli.main(cmd + ["-p", str(tmp_path / "o"), str(p)]) == 0
        assert (tmp_path / "o").read_bytes() == _ref(
            ["-e", "UTF-8", str(p)], "auto")
        return
    with pytest.raises(port.SliceError, match=msg):
        port.run_host(args, out=io.BytesIO())
    assert cli.main(cmd + [str(p)]) == 1
    assert "needs --dist-coord" in capsys.readouterr().err
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(b"x" * 99)))
    assert cli.main(cmd) == 1
    err = capsys.readouterr().err
    assert "distributed scan requires file inputs (stdin cannot be " \
        "sharded across processes)" in err


def test_check_slice_admits_every_encoding_and_hot_group(tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(b"some text here\x00" * 10)
    argv = [a for e in ALL_41 for a in ("-e", e)]
    args = parse_args(argv + ["--hot-group", "8", "--stream-file-min", "1",
                              "--checkpoint", str(tmp_path / "ck"), str(p)])
    port.check_slice(args, Missions.from_args(args))  # no refusal
    # --hot-group is accepted and changes nothing: one launch serves all
    a, b = io.BytesIO(), io.BytesIO()
    assert port.run(parse_args(argv + [str(p)]), out=a, device="cpu") == 0
    assert port.run(parse_args(argv + ["--hot-group", "2", str(p)]), out=b,
                    device="cpu") == 0
    assert a.getvalue() == b.getvalue() and a.getvalue().count(b"\n") > 40
