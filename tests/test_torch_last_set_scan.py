"""ISO-2022-JP's last-set scan (stringsext_tpu_torch/ops/classify_iso2022.py
`_scan_last_sets`, the kernel csrc/last_set_scan.cu on the card) on the CPU:
its plain version against the JAX package's `_scan_last_set` and a numpy
`np.maximum.accumulate` form, on random lanes and on the edges of the
contract (nothing set, everything set, values up to 2**31 - 1, negative
values other than -1, a value in one tile of three, values only at the
kernel's tile boundaries, n = 1 and a tile +- 1); the wrapper's checks; a
mirror of the kernel's tiles, per-thread runs, shuffle scans and decoupled
look-back, its tiles publishing in shuffled orders; and the counters of a
fed scan. Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsext_tpu.ops.classify_iso2022 as JI
from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import classify_iso2022 as TI
from stringsext_tpu_torch.ops import device_events as de
from stringsext_tpu_torch.utils import profiling

# One thread for torch's CPU ops: the inputs are small, and the test run's
# workers together already use every core.
torch.set_num_threads(1)

CPU = torch.device("cpu")
INT32_MAX = 2 ** 31 - 1

# csrc/last_set_scan.cu's shape: 16 positions a thread, 8 warps of 32
ITEMS, LANES, WARPS = 16, 32, 8
TILE = ITEMS * LANES * WARPS
assert TILE == TI._SCAN_TILE

# one trace a length (eager JAX takes seconds)
_jax_scan = jax.jit(JI._scan_last_set)


def _lane(n, case, seed):
    """An int32 lane of `case` over n positions: "random" (a tenth set,
    values 0-3, the rest -1 or another negative), "unset" (all -1), "all"
    (every position set), "big" (a hundredth set, values up to
    2**31 - 1, the largest among them), "sparse" (about one set position
    in three tiles of the kernel, as a mode lane's rare escapes) or
    "tiles" (set only at the last and first position of each tile)."""
    r = np.random.default_rng(seed)
    t = np.where(r.random(n) < 0.9, -1, r.integers(0, 4, n))
    t = np.where(r.random(n) < 0.05, r.integers(-5, -1, n), t)
    if case == "unset":
        t = np.full(n, -1)
    elif case == "all":
        t = r.integers(0, 4, n)
    elif case == "big":
        t = np.where(r.random(n) < 0.01, r.integers(0, INT32_MAX, n,
                                                    endpoint=True), -1)
        t[r.integers(0, n)] = INT32_MAX
    elif case == "sparse":
        t = np.where(r.random(n) < 1 / (3 * TILE), r.integers(0, 4, n), -1)
    elif case == "tiles":
        t = np.full(n, -1)
        ends = np.arange(TILE - 1, n, TILE)
        t[ends] = ends // TILE % 4
        t[np.minimum(ends + 1, n - 1)] = 7
    return t.astype(np.int32)


def _numpy_scan(t):
    """The numpy form of iso2022_state_hot_np's mode: the index of the
    last set position by np.maximum.accumulate, then a gather."""
    idx = np.arange(len(t))
    last = np.maximum.accumulate(np.where(t >= 0, idx, -1))
    return np.where(last >= 0, t[np.maximum(last, 0)], -1).astype(np.int32)


CASES = ["random", "unset", "all", "big", "sparse", "tiles"]
SIZES = [1, 2, 17, TILE - 1, TILE, TILE + 1, 9001]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_equals_the_reference_and_numpy(n, case):
    t = _lane(n, case, seed=n)
    want = _numpy_scan(t)
    np.testing.assert_array_equal(np.asarray(_jax_scan(jnp.asarray(t))),
                                  want)
    ref = TI._scan_last_set_ref(torch.from_numpy(t))
    assert ref.dtype == torch.int32 and ref.shape == (n,)
    np.testing.assert_array_equal(ref.numpy(), want)
    other = _lane(n, "random", seed=n + 1)
    for a, b in ((t, other), (other, t)):  # each lane in either place
        got = TI._scan_last_sets(torch.from_numpy(a), torch.from_numpy(b))
        assert len(got) == 2 and all(g.dtype == torch.int32 for g in got)
        np.testing.assert_array_equal(got[0].numpy(), _numpy_scan(a))
        np.testing.assert_array_equal(got[1].numpy(), _numpy_scan(b))
    if case == "unset":
        assert (want == -1).all()
    if case == "all":
        np.testing.assert_array_equal(want, t)


def test_empty_lanes_come_back_as_they_are():
    e = torch.empty(0, dtype=torch.int32)
    f = torch.empty(0, dtype=torch.int32)
    got = TI._scan_last_sets(e, f)
    assert got[0] is e and got[1] is f


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.from_numpy(_lane(64, "random", seed=1))
    meta = torch.empty(64, dtype=torch.int32, device="meta")
    bad = [
        (t.to(torch.int64), t),  # an int64 lane
        (t, t.to(torch.int16)),  # a lane of int16
        (t, t[:-1]),  # another length
        (t.reshape(8, 8), t.reshape(8, 8)),  # 2-D lanes
        (t, torch.cat([t, t])[::2]),  # a strided lane
        (t, meta),  # two devices
        (meta, meta),  # a device that is neither cuda nor cpu
    ]
    for lanes in bad:
        with pytest.raises(ValueError):
            TI._scan_last_sets(*lanes)


def _then(a, b):
    """The composition of two transfers, a then b (the kernel's `then`)."""
    return np.where(b >= 0, b, a)


def _shfl_scan(x):
    """An inclusive scan along the last axis as the kernel's
    `__shfl_up_sync` loop takes it: at distance d, a lane at or past d
    composes the value d lanes before it with its own."""
    width = x.shape[-1]
    lane = np.arange(width)
    d = 1
    while d < width:
        o = np.concatenate([np.full(x.shape[:-1] + (d,), -1), x[..., :-d]],
                           -1)
        x = np.where(lane >= d, _then(o, x), x)
        d *= 2
    return x


def _shift_in(x):
    """The exclusive form: the value one lane before, -1 at lane 0."""
    return np.concatenate([np.full(x.shape[:-1] + (1,), -1), x[..., :-1]],
                          -1)


def _window_fold(x):
    """Lane 0's composition of a window's 32 values, oldest (the last
    lane) to newest (lane 0), as the look-back's `__shfl_down_sync` loop
    takes it: at distance d, a lane whose lane + d is in the warp composes
    that lane's value before its own."""
    lane = np.arange(len(x))
    d = 1
    while d < len(x):
        o = np.concatenate([x[d:], x[len(x) - d:]])  # past the warp: its own
        x = np.where(lane + d < len(x), _then(o, x), x)
        d *= 2
    return x[0]


def _look_back(aggs, rng):
    """The tiles' exclusive prefixes by the kernel's look-back: tiles
    take their tickets in order, and a random schedule interleaves their
    steps (publish once the tile is scanned, read a window of 32
    predecessors, publish the inclusive value), so a window may hold
    tiles that have not published yet. A tile that holds a value, and
    tile 0, publish INCL at once. Returns the prefixes."""
    tiles = len(aggs)
    flag = np.zeros(tiles, np.int64)  # 0 none, 1 AGG, 2 INCL
    value = np.zeros(tiles, np.int64)
    prefix = [None] * tiles
    state = {}  # a running tile: None before it publishes, else the
    started = 0  # nearest predecessor of its window and the prefix so far
    while started < tiles or state:
        if started < tiles and (not state or rng.random() < 0.5):
            state[started] = None  # the ticket
            started += 1
            continue
        t = list(state)[rng.integers(len(state))]
        if state[t] is None:
            own = aggs[t] >= 0 or t == 0
            flag[t], value[t] = (2 if own else 1), aggs[t]
            if t == 0:
                prefix[0] = -1
                del state[t]
            else:
                state[t] = (t - 1, -1)
            continue
        pred, acc = state[t]
        idx = pred - np.arange(LANES)
        f = np.where(idx >= 0, flag[np.maximum(idx, 0)], 2)
        v = np.where(idx >= 0, value[np.maximum(idx, 0)], -1)
        stops = np.flatnonzero(f == 2)
        first = stops[0] if len(stops) else LANES - 1
        if not (f[:first + 1] != 0).all():
            continue  # wait: the kernel reads the window again
        assert (v[:first][f[:first] == 1] == -1).all()  # AGGs: the identity
        win = np.where(np.arange(LANES) <= first, v, -1)
        acc = int(_then(_window_fold(win), acc))
        if len(stops):
            prefix[t] = acc
            if aggs[t] < 0:
                flag[t], value[t] = 2, prefix[t]
            del state[t]
        else:
            state[t] = (pred - LANES, acc)
    return np.array(prefix, np.int64)


def _mirror(t, rng):
    """csrc/last_set_scan.cu step by step in numpy, one lane."""
    n = len(t)
    tiles = -(-n // TILE)
    v = np.concatenate([t.astype(np.int64),
                        np.full(tiles * TILE - n, -1)])
    v = v.reshape(tiles, WARPS, LANES, ITEMS)
    run = v.copy()  # a thread's running value over its 16 positions
    m = np.full(v.shape[:-1], -1)
    for k in range(ITEMS):
        m = _then(m, v[..., k])
        run[..., k] = m
    incl = _shfl_scan(m)  # in a warp
    excl = _shift_in(incl)
    w = _shfl_scan(incl[..., -1])  # warp l's scan of the warp totals
    prefix = _look_back(w[:, -1], rng)
    warp_prefix = _then(prefix[:, None], _shift_in(w))
    pre = _then(warp_prefix[..., None], excl)
    out = _then(pre[..., None], run)
    return out.reshape(-1)[:n].astype(np.int32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, TILE - 1, TILE + 1, 3 * TILE + 100,
                               40 * TILE - 3])
def test_kernel_mirror_equals_the_plain_version(n, case):
    rng = np.random.default_rng(n)
    for seed in (n, n + 7):
        t = _lane(n, case, seed=seed)
        want = TI._scan_last_set_ref(torch.from_numpy(t)).numpy()
        for _ in range(2 if n > TILE else 1):  # two schedules
            np.testing.assert_array_equal(_mirror(t, rng), want,
                                          err_msg=str(seed))


def _iso_corpus(n, seed):
    """Printable bytes with ISO-2022-JP escapes and LEAD pairs."""
    r = np.random.default_rng(seed)
    d = bytearray(r.integers(0x20, 0x7F, n, np.uint8).tobytes())
    frags = [b"\x1b$B\x30\x6c\x30\x6c", b"\x1b(B", b"\x1b(J", b"\x1b(I",
             b"\x1b$@", b"\x1b", b"\x1b$X"]
    for p in r.integers(0, n - 8, n // 50):
        f = frags[int(r.integers(0, len(frags)))]
        d[p:p + len(f)] = f
    return np.frombuffer(bytes(d), np.uint8)


def test_counters_count_the_iso_pieces(monkeypatch):
    """On the CPU every ISO-2022-JP piece is scanned by the plain version:
    `feed.chain.iso_pieces` counts the pieces, `iso.scan.kernel` and the
    kernel's launches stay 0, and the other chain kinds count no ISO
    piece."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    monkeypatch.setattr(profiling, "_counts", type(profiling._counts)(int))
    monkeypatch.setattr(profiling, "_stats", type(profiling._stats)(
        profiling._stats.default_factory))
    launches = TI._scan_last_sets.launches
    data = _iso_corpus(3001, seed=4)
    for enc, chunk, iso in (("ISO-2022-JP", 1024, 3), ("ISO-2022-JP", 500, 7),
                            ("Shift_JIS", 1024, 0)):
        m = Missions.new(flag_encoding=[enc]).v[0]
        before = dict(profiling._counts)
        de.runtable_feed(data, m, CPU, with_extras=True, chunk=chunk)
        pieces = (profiling._counts["feed.chain.pieces"]
                  - before.get("feed.chain.pieces", 0))
        isos = (profiling._counts["feed.chain.iso_pieces"]
                - before.get("feed.chain.iso_pieces", 0))
        assert pieces == -(-3001 // chunk), enc
        assert isos == iso, enc
    assert profiling._counts["iso.scan.kernel"] == 0
    assert TI._scan_last_sets.launches == launches == 0
