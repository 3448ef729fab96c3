"""The feed's report clamp (stringsext_tpu_torch/ops/device_events.py
`_report_clamp`, the kernel csrc/report_clamp.cu on the card) on the CPU:
its plain version against the six torch ops the feed ran inline before
it, on random lanes and on the edges of the contract (no event, every
position an event, report-clamped chars, a carried max of -1, inside the
piece and past its end, short and odd lengths); the wrapper's checks; a
mirror of the kernel's tiles and decoupled look-back, its tiles
publishing in shuffled orders; the run-table feed in pieces of 2, 6 and
1022 bytes against one piece, for a UTF-8 and a Shift_JIS mission; and
the counters of the clamped pieces. Every comparison is exact."""

import numpy as np
import pytest
import torch

from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import device_events as de
from stringsext_tpu_torch.utils import profiling

CPU = torch.device("cpu")
INT32_MIN = -(2 ** 31)


def _inline(start, pending, acc, report_off, length, lo):
    """The report clamp as `_piece_feed` ran it inline: arange, where,
    cummax, clamp, the compare and the `&`."""
    idx = torch.arange(acc.shape[0], dtype=torch.int32, device=acc.device)
    evt = start & ~pending
    rep = torch.where(evt, idx + report_off, -1)
    rep_max = torch.clamp(torch.cummax(rep, dim=0).values, min=lo)
    feedable = acc & (rep_max == idx + length - 1)
    return feedable, int(rep_max[-1])


def _lanes(n, case, seed):
    """(start, pending, acc, report_off, length) of `case` over n
    positions: "random" (events a third of the positions, lengths 1-4,
    reports mostly at the char's last byte), "none" (no event), "all"
    (every position an event) or "clamped" (reports past the char's last
    byte, so later chars are clamped)."""
    r = np.random.default_rng(seed)
    length = r.integers(1, 5, n).astype(np.int32)
    report_off = length - 1
    start = r.random(n) < 0.35
    pending = r.random(n) < 0.05
    if case == "none":
        start[:] = False
    elif case == "all":
        start[:] = True
        pending[:] = False
    elif case == "clamped":
        late = r.random(n) < 0.1
        report_off = np.where(late, report_off + r.integers(1, 40, n),
                              report_off)
    acc = start & (r.random(n) < 0.8)
    return tuple(torch.from_numpy(x) for x in (
        start, pending, acc, report_off.astype(np.int32), length))


def _los(n):
    return (-1, n // 2, n - 1, n + 5)


@pytest.mark.parametrize("case", ["random", "none", "all", "clamped"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 17, 4095, 4096, 4097, 9001])
def test_twin_equals_the_inline_ops(n, case):
    lanes = _lanes(n, case, seed=n)
    for lo in _los(n):
        want, want_last = _inline(*lanes, lo)
        for fn in (de._report_clamp, de._report_clamp_ref):
            got, last = fn(*lanes, lo)
            assert got.dtype == torch.bool and got.shape == (n,)
            assert last.dtype == torch.int32 and last.dim() == 0
            assert torch.equal(got, want), (fn.__name__, lo)
            assert int(last) == want_last, (fn.__name__, lo)
        if case == "none":
            assert int(last) == lo and not got.any()
        if case == "clamped" and lo == -1 and n > 100:
            assert (lanes[2] & ~got).any()  # some accepted chars excluded


def test_twin_takes_the_slices_the_feed_gives():
    """Lanes sliced 4 bytes into their allocations, as a piece's owned
    bytes past its context are."""
    lanes = _lanes(6000, "clamped", seed=5)
    cut = tuple(t[4:] for t in lanes)
    for lo in (-1, 17):
        got, last = de._report_clamp(*cut, lo)
        want, want_last = _inline(*cut, lo)
        assert torch.equal(got, want) and int(last) == want_last


def test_wrapper_refuses_what_the_kernel_does_not_take():
    s, p, a, ro, ln = _lanes(64, "random", seed=1)
    bad = [
        (s, p, a, ro.to(torch.int8), ln),  # an int lane of int8
        (s, p, a.to(torch.uint8), ro, ln),  # a bool lane of uint8
        (s, p, a, ro, ln[:-1]),  # another length
        (s, p, a, ro, ln.reshape(8, 8)),  # a 2-D lane
        (s, p, a, ro, torch.cat([ln, ln])[::2]),  # a strided lane
    ]
    for lanes in bad:
        with pytest.raises(ValueError):
            de._report_clamp(*lanes, -1)
    with pytest.raises(ValueError):
        de._report_clamp(s, p, a, ro, ln, -2)
    with pytest.raises(ValueError):
        de._report_clamp(s, p, a, ro, ln, 2 ** 31)
    empty = tuple(t[:0] for t in (s, p, a, ro, ln))
    with pytest.raises(ValueError):
        de._report_clamp(*empty, -1)


# csrc/report_clamp.cu's shape: 16 positions a thread, 8 warps of 32
ITEMS, LANES, WARPS = 16, 32, 8
TILE = ITEMS * LANES * WARPS


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)


def _look_back(aggs, lo, rng):
    """The tiles' exclusive prefixes by the kernel's look-back: tiles
    start in ticket order, and a random schedule interleaves their steps
    (publish the aggregate, read a window of 32 predecessors, publish the
    inclusive max). Returns the prefixes."""
    tiles = len(aggs)
    flag = np.zeros(tiles, np.int64)  # 0 none, 1 AGG, 2 INCL
    value = np.zeros(tiles, np.int64)
    prefix = [None] * tiles
    state = {}  # a running tile: (pred, max so far)
    started = 0
    while started < tiles or state:
        can_start = started < tiles
        if can_start and (not state or rng.random() < 0.7):
            t = started
            started += 1
            if t == 0:
                flag[0], value[0] = 2, max(lo, aggs[0])
                prefix[0] = lo
            else:
                flag[t], value[t] = 1, aggs[t]
                state[t] = (t - 1, INT32_MIN)
            continue
        t = list(state)[rng.integers(len(state))]
        pred, run = state[t]
        idx = pred - np.arange(LANES)
        f = np.where(idx >= 0, flag[np.maximum(idx, 0)], 2)
        v = np.where(idx >= 0, value[np.maximum(idx, 0)], lo)
        stops = np.flatnonzero(f == 2)
        first = stops[0] if len(stops) else LANES - 1
        if not (f[:first + 1] != 0).all():
            continue  # wait: the kernel reads the window again
        run = max(run, int(v[:first + 1].max()))
        if len(stops):
            prefix[t] = run
            flag[t], value[t] = 2, max(run, aggs[t])
            del state[t]
        else:
            state[t] = (pred - LANES, run)
    return prefix


def _mirror(start, pending, acc, report_off, length, lo, rng):
    """csrc/report_clamp.cu step by step in numpy: (feedable, last)."""
    n = len(start)
    tiles = -(-n // TILE)
    i = np.arange(tiles * TILE, dtype=np.int64)
    inn = i < n
    pad = lambda x, fill: np.concatenate(  # noqa: E731
        [np.asarray(x), np.full(tiles * TILE - n, fill, np.asarray(x).dtype)])
    evt = pad(start, False) & ~pad(pending, False) & inn
    ev = np.where(evt, _wrap(i + pad(report_off, 0)), INT32_MIN)
    # a thread's running max over its 16 positions
    run = np.maximum.accumulate(ev.reshape(tiles, WARPS, LANES, ITEMS), -1)
    m = run[..., -1]
    incl = np.maximum.accumulate(m, -1)  # the shuffle scan in a warp
    excl = np.concatenate(
        [np.full((tiles, WARPS, 1), INT32_MIN), incl[..., :-1]], -1)
    wtot = incl[..., -1]
    winc = np.maximum.accumulate(wtot, -1)  # warp 0's scan of the warps
    wex = np.concatenate([np.full((tiles, 1), INT32_MIN), winc[:, :-1]], -1)
    prefix = np.array(_look_back(winc[:, -1], lo, rng), np.int64)
    pre = np.maximum(np.maximum(prefix[:, None], wex)[..., None], excl)
    M = np.maximum(pre[..., None], run).reshape(-1)
    target = _wrap(i + pad(length, 1) - 1)
    feed = pad(acc, False) & inn & (M == target)
    return feed[:n], int(M[n - 1])


@pytest.mark.parametrize("case", ["random", "none", "all", "clamped"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * TILE + 100, 40 * TILE - 3])
def test_kernel_mirror_equals_the_twin(n, case):
    lanes = _lanes(n, case, seed=n + 1)
    rng = np.random.default_rng(n)
    np_lanes = [t.numpy() for t in lanes]
    for lo in _los(n):
        want, want_last = de._report_clamp_ref(*lanes, lo)
        for _ in range(2 if n > TILE else 1):  # two schedules
            got, last = _mirror(*np_lanes, lo, rng)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=str(lo))
            assert last == int(want_last), lo


def _text_corpus(enc, n, seed):
    """Random bytes with text of `enc` every 300 bytes and malformed
    sequences that clamp reports."""
    r = np.random.default_rng(seed)
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    text = "テキスト text ö \U0001F600 ".encode(
        "shift_jis" if enc == "Shift_JIS" else "utf-8",
        errors="replace" if enc == "Shift_JIS" else "strict")
    for off in range(37, n - len(text) - 8, 300):
        data[off:off + len(text)] = text
        data[off + len(text):off + len(text) + 3] = b"\xe3\x81\x82"[:2] + b"A"
    return np.frombuffer(bytes(data), np.uint8)


def _same(got, want, where):
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


@pytest.mark.parametrize("enc", ["UTF-8", "Shift_JIS"])
def test_feed_in_small_pieces_equals_one_piece(enc):
    data = _text_corpus(enc, 3001, seed=len(enc))
    m = Missions.new(flag_encoding=[enc]).v[0]
    for extras in (False, True):
        want = de.runtable_feed(data, m, CPU, with_extras=extras)
        assert want is not None
        for chunk in (1022, 6, 2):
            _same(de.runtable_feed(data, m, CPU, with_extras=extras,
                                   chunk=chunk),
                  want, f"{enc} extras={extras} chunk={chunk}")


def test_counters_count_the_pieces(monkeypatch):
    """On the CPU every piece is clamped by the plain version: the
    kernel's launches stay 0 and `feed.pieces` counts the pieces."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    monkeypatch.setattr(profiling, "_counts", type(profiling._counts)(int))
    monkeypatch.setattr(profiling, "_stats", type(profiling._stats)(
        profiling._stats.default_factory))
    launches = de._report_clamp.launches
    data = _text_corpus("UTF-8", 3001, seed=2)
    for enc, chunk in (("UTF-8", 1022), ("Shift_JIS", 6)):
        m = Missions.new(flag_encoding=[enc]).v[0]
        before = profiling._counts["feed.pieces"]
        de.runtable_feed(data, m, CPU, with_extras=True, chunk=chunk)
        assert profiling._counts["feed.pieces"] - before == -(-3001 // chunk)
    assert profiling._counts["feed.clamp.kernel"] == 0
    assert de._report_clamp.launches == launches == 0
