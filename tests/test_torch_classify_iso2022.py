"""The port's ISO-2022-JP lanes (stringsext_tpu_torch/ops/classify_iso2022.py)
and its run-table feed against the JAX package on the CPU:
`iso2022_lanes`, `iso_pre_lanes` from carried entry states,
`iso_state_transfer`, the numpy `iso2022_state_hot_np` against the lanes'
`state_hot`, the feed whole and in pieces whose seams cut escapes, LEAD
pairs, LEAD-mode runs over several pieces and the redundant-escape flag
(the seam cases of tests/test_parallel.py), and the CLI with the feed on
and off, buffered and streamed. Inputs come from numpy seeds; every
comparison is exact (tolerance 0), dtypes included."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsext_tpu.ops.classify_iso2022 as JI
import stringsext_tpu.run as ref_run
from stringsext_tpu.cli import parse_args as ref_parse_args
from stringsext_tpu.mission import Missions as RefMissions
from stringsext_tpu.ops import device_events as jde
from stringsext_tpu_torch import run as port
from stringsext_tpu_torch.cli import parse_args
from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import classify_iso2022 as TI
from stringsext_tpu_torch.ops import device_events as de

# One thread for torch's CPU ops: the inputs are small, and the test run's
# workers together already use every core.
torch.set_num_threads(1)

CPU = torch.device("cpu")
CAP = 4096
FRAGS = [b"\x1b", b"\x1b(", b"\x1b(B", b"\x1b(I", b"\x1b(J", b"\x1b$B",
         b"\x1b$@", b"\x1b$X", b"\x1b$B\x30\x6c", b"\x0e\x0f"]


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.flatnonzero(got != want)
    assert not len(bad), (what, bad[:10])


def _fuzz(seed, n):
    """Printable bytes with escape fragments (valid, invalid, truncated)
    and LEAD pairs planted at random."""
    r = np.random.default_rng(seed)
    d = r.integers(0x20, 0x7F, n, np.uint8)
    for _ in range(n // 40):
        p = int(r.integers(0, n))
        f = FRAGS[int(r.integers(0, len(FRAGS)))]
        d[p:p + len(f)] = np.frombuffer(f, np.uint8)[:max(0, min(len(f),
                                                                  n - p))]
    return d


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_iso2022_lanes_equal_the_reference(seed):
    for n in (CAP, 3001, 2):
        pad = np.zeros(CAP, np.uint8)
        pad[:n] = _fuzz(seed, n)
        jl, jh = JI.iso2022_lanes(jnp.asarray(pad), n)
        tl, th = TI.iso2022_lanes(torch.from_numpy(pad), n)
        for f in jl._fields:
            _eq(getattr(tl, f), getattr(jl, f), (n, f))
        _eq(th, jh, (n, "state_hot"))
        np.testing.assert_array_equal(TI.iso2022_state_hot_np(pad[:n]),
                                      th.numpy()[:n])


@pytest.mark.parametrize("entry", [(0, -1, 0), (3, 1, 4), (1, 0, 7),
                                   (2, -1, 4)])
def test_iso_pre_lanes_and_transfer_equal_the_reference(entry):
    """From a carried (mode, flag) with the effects before effect_lo
    masked out, as the mesh and the feed's pieces enter a span."""
    mode, flag, lo = entry
    pad = np.zeros(CAP, np.uint8)
    n = 3500
    pad[:n] = _fuzz(len(entry) + lo, n)
    jp, js, jh = _jax_pre(jnp.asarray(pad), n, mode, flag, lo)
    tp, ts, th = TI.iso_pre_lanes(torch.from_numpy(pad), n, mode, flag, lo)
    for f in jp._fields:
        _eq(getattr(tp, f), getattr(jp, f), f)
    _eq(ts, js, "step")
    _eq(th, jh, "state_hot")
    for hi in (lo, 1000, n, CAP):
        _eq(TI.iso_state_transfer(torch.from_numpy(pad), n, lo, hi),
            _jax_transfer(jnp.asarray(pad), n, lo, hi), hi)


# one trace each for every entry state and span (eager JAX takes seconds)
_jax_pre = jax.jit(JI.iso_pre_lanes)
_jax_transfer = jax.jit(JI.iso_state_transfer)


def test_scan_last_set_is_the_reference():
    v = np.random.default_rng(5).integers(-3, 4, 1000).astype(np.int32)
    v[:7] = -1
    _eq(TI._scan_last_sets(torch.from_numpy(v), torch.from_numpy(v))[0],
        JI._scan_last_set(jnp.asarray(v)), "scan")


# ------------------------------------------------------------------ feed


def _same(got, want, where="feed"):
    if want is None:
        assert got is None, where
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{k}]")
        return
    assert got.dtype == want.dtype, where
    np.testing.assert_array_equal(got, want, err_msg=where)


def _seam_corpus(seed, piece=1024, n=9000):
    """The seam cases of tests/test_parallel.py at every `piece` seam:
    an escape split 1-3 bytes before it, a LEAD pair split across it, a
    mode set in one piece and read in the next, the redundant-escape flag
    set at a seam's last bytes and read after it; and a LEAD-mode run
    over several pieces."""
    r = np.random.default_rng(seed)
    d = r.integers(0x20, 0x7F, n, np.uint8)
    kanji = "漢字テスト".encode("iso-2022-jp")[3:-3]
    cases = [
        b"\x1b$B" + kanji + b"\x1b(B ascii",
        b"txt\x1b(J\x1b(Bmore\x1b",
        b"\x1b(I\x31\x32\x1b(B",
        b"\x1b$B" + kanji[:3],
    ]
    for k, s in enumerate(range(piece, n - 64, piece)):
        t = cases[k % len(cases)]
        off = s - 1 - k % 3
        d[off:off + len(t)] = np.frombuffer(t, np.uint8)
    body = ("漢" * 1500).encode("iso-2022-jp")[3:-3]
    at = piece + 101
    d[at - 3:at] = np.frombuffer(b"\x1b$B", np.uint8)
    d[at:at + min(len(body), n - at - 4)] = np.frombuffer(body, np.uint8)[
        :min(len(body), n - at - 4)]
    d[n - 2:] = np.frombuffer(b"\x1b$", np.uint8)  # truncated at the end
    return d


@pytest.mark.parametrize("flags", [{}, {"flag_unicode_block_filter": "All"}])
@pytest.mark.parametrize("piece", [1024, 4096])
def test_feed_equals_the_reference_in_pieces(piece, flags):
    d = _seam_corpus(piece, piece)
    m = Missions.new(flag_encoding=["ISO-2022-JP"], **flags).v[0]
    rm = RefMissions.new(flag_encoding=["ISO-2022-JP"], **flags).v[0]
    for extras in (False, True):
        want = jde.runtable_feed(d, rm, device=True, with_extras=extras)
        _same(jde.runtable_feed(d, rm, device=False, with_extras=extras),
              want, "reference host")
        assert want is not None
        for chunk in (1 << 26, piece, 62):
            _same(de.runtable_feed(d, m, CPU, with_extras=extras,
                                   chunk=chunk), want,
                  f"extras={extras} chunk={chunk}")
        _same(de._feed_from_host_events(d, m, "iso-2022-jp", extras), want,
              "oracle")


def test_redundant_escape_flag_across_a_seam():
    """A valid escape ends one piece and another starts the next: the
    second is a redundant-escape error whose lanes need the flag carried
    over (tests/test_parallel.py's iso-redundant-across-seam)."""
    base = np.frombuffer(_seam_corpus(9, 512, 2048).tobytes(), np.uint8)
    m = Missions.new(flag_encoding=["ISO-2022-JP"]).v[0]
    rm = RefMissions.new(flag_encoding=["ISO-2022-JP"]).v[0]
    for split in (0, 1, 2, 3):  # bytes of the second escape before the seam
        d = base.copy()
        d[1021 - split:1027 - split] = np.frombuffer(b"\x1b(J\x1b(B", np.uint8)
        want = jde.runtable_feed(d, rm, device=True, with_extras=True)
        _same(de.runtable_feed(d, m, CPU, with_extras=True, chunk=1024),
              want, split)


# ------------------------------------------------------------------- CLI


def _stream_corpus(n=400 * 1024, seed=13):
    """tests/test_runtable_feed.py's streaming corpus, with the mode
    switch planted across chunk seams."""
    r = np.random.default_rng(seed)
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    texts = [
        ("Привет мир! ёлочка " * 30).encode("utf-8"),
        b"\x1b$B"
        + ("こんにちは世界。国際化テストです。".encode("iso2022_jp")[3:-3]) * 12
        + b"\x1b(B",
        ("mode 日本語 switch ascii 漢字 " * 20).encode("iso2022_jp"),
    ]
    for off in range(2048, n - 4096, 12288):
        t = texts[(off // 12288) % len(texts)]
        data[off:off + len(t)] = t
    for off in range(5000, n - 16, 23456):
        data[off:off + 3] = b"\x1b$B"
    return bytes(data)


def test_cli_feed_on_and_off_equal_the_reference(tmp_path, monkeypatch):
    """Buffered and streamed (8 KiB chunks: ISO-2022-JP takes the feed in
    a chunk entered in ground state, the hot map in others), feed on and
    off, against the reference's engine=auto."""
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    blob = _stream_corpus()
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", "ISO-2022-JP", "-e", "UTF-8", "-n", "4"]
    buf = io.BytesIO()
    assert ref_run.run(ref_parse_args(argv + [str(p)]), out=buf,
                       engine="auto") == 0
    want = buf.getvalue()
    assert want.count(b"\n") > 100
    fed = []
    real = de._chain_piece_lanes
    monkeypatch.setattr(de, "_chain_piece_lanes", lambda *a: (
        fed.append(a[1]), real(*a))[1])
    for feed in ("1", "0"):
        monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", feed)
        fed.clear()
        out = io.BytesIO()
        assert port.run(parse_args(argv + [str(p)]), out=out,
                        device="cpu") == 0
        assert out.getvalue() == want, feed
        assert bool(fed) == (feed == "1")
        args = parse_args(argv + ["-"])
        out = io.BytesIO()
        assert port._run_streaming_stdin(
            args, Missions.from_args(args), out, src=io.BytesIO(blob),
            chunk_bytes=8192, device="cpu") == 0
        assert out.getvalue() == want, feed
