"""The port's CJK lanes and event-chain orbit
(stringsext_tpu_torch/ops/classify_cjk.py) and the run-table feed of the
CJK kinds (ops/device_events.py) against the JAX package on the CPU:
`cjk_lanes` / `cjk_pre_lanes` per kind, the three orbit resolves (by the
property cases of tests/test_device.py), a step-by-step mirror of the
orbit kernel's design (csrc/orbit_resolve.cu) against its plain version,
the feed whole and in 1 KiB and 4 KiB pieces whose seams cut characters,
the Big5 multi-codepoint extras, the CLI with the feed on and off, and
feed positions past 2 GiB. Inputs come from numpy seeds; every comparison
is exact (tolerance 0), dtypes included."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsext_tpu.ops.classify_cjk as JC
import stringsext_tpu.run as ref_run
from stringsext_tpu.cli import parse_args as ref_parse_args
from stringsext_tpu.mission import Missions as RefMissions
from stringsext_tpu.ops import device_events as jde
from stringsext_tpu_torch import run as port
from stringsext_tpu_torch.cli import parse_args
from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import classify_cjk as TC
from stringsext_tpu_torch.ops import device_events as de
from stringsext_tpu_torch.ops.runs import filter_words

# One thread for torch's CPU ops: the inputs are small, and the test run's
# workers together already use every core.
torch.set_num_threads(1)

CPU = torch.device("cpu")

PLANTS = {
    "big5": ["香港繁體字測試".encode("big5"), b"\x88\x62\xa4\x40\x88\x64"],
    "euc-jp": [b"\x8f\xa2\xaf\x8f\xa2\xaf" + "日本語".encode("euc_jp"),
               "ｶﾀｶﾅ".encode("euc_jp")],
    "euc-kr": ["한국어 테스트".encode("euc-kr")],
    "gb18030": ["\U0001F600四字节 OK".encode("gb18030"),
                b"\x90\x30\x81\x30\x81\x30\x81\x30", b"\x81\x30\x81"],
    "shift_jis": ["カタカナ試験 ｶﾅ".encode("shift_jis")],
}


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.flatnonzero(got != want)
    assert not len(bad), (what, bad[:10])


def _planted(kind, n, seed, seams=()):
    """Random bytes with the kind's plants every 97 bytes and, at each
    seam, one that straddles it by 1-3 bytes."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, n, np.uint8)
    ps = PLANTS[kind]
    for k, off in enumerate(range(11, n - 64, 97)):
        t = ps[k % len(ps)]
        d[off:off + len(t)] = np.frombuffer(t, np.uint8)
    for k, s in enumerate(seams):
        t = ps[k % len(ps)]
        off = s - 1 - k % 3
        if 0 <= off and off + len(t) <= n:
            d[off:off + len(t)] = np.frombuffer(t, np.uint8)
    return d


# ----------------------------------------------------------------- lanes


@pytest.mark.parametrize("n", [5000, 8192])
@pytest.mark.parametrize("kind", TC.CJK_KINDS)
def test_cjk_lanes_equal_the_reference(kind, n):
    d = _planted(kind, n, seed=n + len(kind))
    cap = 8192
    pad = np.zeros(cap, np.uint8)
    pad[:n] = d
    jl, jm = JC.cjk_lanes(jnp.asarray(pad), kind, n)
    tl, tm = TC.cjk_lanes(torch.from_numpy(pad), kind, n)
    for f in jl._fields:
        _eq(getattr(tl, f), getattr(jl, f), f)
    _eq(tm, jm, "multi")
    if kind == "big5":
        assert tm.any()
    jp, js = JC.cjk_pre_lanes(jnp.asarray(pad), kind, n)
    tp, ts = TC.cjk_pre_lanes(torch.from_numpy(pad), kind, n)
    for f in jp._fields:
        _eq(getattr(tp, f), getattr(jp, f), "pre " + f)
    _eq(ts, js, "step")


def test_gb18030_four_byte_ranges_equal_the_reference():
    """Every 7th four-byte pointer of both ranges, and the invalid gaps:
    `bucketize` on the range starts gives the reference's telescoping
    compare-sum's codepoints."""
    ptrs = np.concatenate([np.arange(0, 39420, 7), np.arange(39420, 40000, 11),
                           np.arange(189000, 1237576, 977),
                           [1237575, 1237576]])
    b0 = 0x81 + ptrs // 12600
    b1 = 0x30 + ptrs // 1260 % 10
    b2 = 0x81 + ptrs // 10 % 126
    b3 = 0x30 + ptrs % 10
    d = np.stack([b0, b1, b2, b3], 1).reshape(-1).astype(np.uint8)
    jl, _ = JC.cjk_lanes(jnp.asarray(d), "gb18030", len(d))
    tl, _ = TC.cjk_lanes(torch.from_numpy(d), "gb18030", len(d))
    for f in jl._fields:
        _eq(getattr(tl, f), getattr(jl, f), f)
    assert int((tl.cp >= 0x10000).sum()) > 1000


# ----------------------------------------------------------------- orbit


def _orbit_chain(step, n, start=0):
    cap = len(step)
    out = np.zeros(cap, bool)
    p = int(start)
    while p < min(n, cap):
        out[p] = True
        p += max(int(step[p]), 1)
    return out


def _steps(rng, cap, top=5):
    step = rng.integers(1, top, cap).astype(np.int32)
    n = int(rng.integers(cap // 2, cap + 1))
    for _ in range(3):  # claim-rest steps near the end
        i = int(rng.integers(max(n - 8, 0), n))
        step[i] = max(n - i, 1)
    return step, n


@pytest.mark.parametrize("seed", [41, 42])
def test_blocked_orbit_equals_the_reference_and_the_chain(seed):
    """tests/test_device.py's property cases: random step fields,
    claim-rest tails, starts in and past block 0, caps and ends that are
    not multiples of 512."""
    rng = np.random.default_rng(seed)
    for trial in range(4):
        cap = int(rng.choice([2048, 4096, 5120, 8192, 12288]))
        step, n = _steps(rng, cap)
        start = int(rng.choice([0, 1, 3, 4, 5, 7, 515, 600]))
        got = TC._orbit_mask_blocked(torch.from_numpy(step), n, start)
        want = np.asarray(JC._orbit_mask_blocked(
            jnp.asarray(step), jnp.int32(n), start))
        _eq(got, want, (trial, cap, n, start))
        assert (want == _orbit_chain(step, n, start)).all()
        _eq(TC._orbit_mask(torch.from_numpy(step), n, start),
            np.asarray(JC._orbit_mask(jnp.asarray(step), n, start)), "mask")


def test_multi_start_and_doubling_orbits_equal_the_reference():
    rng = np.random.default_rng(43)
    for trial in range(4):
        cap = int(rng.choice([300, 700, 2048, 5120]))
        step, n = _steps(rng, cap)
        starts = np.array([0, 4, 5, 7], np.int32)
        got = TC._orbit_masks_block0(torch.from_numpy(step), n,
                                     torch.from_numpy(starts))
        want = np.asarray(JC._orbit_masks_block0(jnp.asarray(step), n,
                                                 jnp.asarray(starts)))
        _eq(got, want, (trial, cap, n))
        for start in (0, 3, 9):  # pointer doubling below 4 blocks
            small = step[:min(cap, 1500)]
            _eq(TC._orbit_mask(torch.from_numpy(small), min(n, 1400), start),
                np.asarray(JC._orbit_mask(jnp.asarray(small), min(n, 1400),
                                          start)), (trial, start))


_B, _SEG, _DEAD = 512, 32, 4
_IDENT = 0 | 1 << 3 | 2 << 6 | 3 << 9 | 4 << 12
_EXITS = 0 | 1 << 3 | 2 << 6 | 3 << 9
_AGG, _INCL, _MAP = 1 << 16, 2 << 16, 0x7FFF


def _apply(m, x):
    return (m >> (3 * x)) & 7


def _compose(first, then):
    r = 0
    for x in range(5):
        r = r | (_apply(then, _apply(first, x)) << (3 * x))
    return r


def _const(x):
    return x * 0x1249


def _is_const(m):
    return m == _const(m & 7)


def _walk_block(s, bbase, r, n, marks=None):
    """The kernel's `walk_block`: the reference's walk through one block
    of 512 from offset r over its steps `s`; returns the exit state."""
    while r < _B:
        i = bbase + r
        if i >= n:
            return _DEAD
        if marks is not None:
            marks[r] = True
        sf = max(int(s[r]), 1)
        if i + sf >= n:
            return _DEAD
        r += sf
    return r - _B if r - _B < 4 else _DEAD


def _look_back(agg, rng):
    """The kernel's decoupled look-back over the tiles' aggregate maps,
    with the tiles' turns in a random order: a turn publishes the
    aggregate (INCL at once when it is constant) or reads one window of 32
    predecessors, and leaves it for a later turn when one before the
    nearest INCL is unpublished. Returns each tile's entry state."""
    T = len(agg)
    status = [0] * T
    acc, pred = [_IDENT] * T, [t - 1 for t in range(T)]
    entry = [None] * T
    published = [False] * T
    todo = list(range(T))
    while todo:
        t = todo[int(rng.integers(len(todo)))]
        if not published[t]:
            status[t] = (_INCL if _is_const(agg[t]) else _AGG) | agg[t]
            published[t] = True
            continue
        words = [status[i] if i >= 0 else _INCL | _const(_DEAD)
                 for i in range(pred[t], pred[t] - 32, -1)]
        stops = [k for k, w in enumerate(words) if w & _INCL]
        first = stops[0] if stops else 31
        if not all(words[:first + 1]):
            continue  # the kernel spins here
        v = [w & _MAP if k <= first else _IDENT for k, w in enumerate(words)]
        d = 1
        # the shuffle tree (none when the nearest is INCL): the higher
        # lane holds the earlier tiles
        while first > 0 and d < 32:
            v = [_compose(v[k + d], v[k]) if k + d < 32 else v[k]
                 for k in range(32)]
            d *= 2
        acc[t] = _compose(v[0], acc[t])
        if not stops:
            pred[t] -= 32
            continue
        assert _is_const(acc[t])
        entry[t] = acc[t] & 7
        if not _is_const(agg[t]):
            status[t] = _INCL | _const(_apply(agg[t], entry[t]))
        todo.remove(t)
    return np.array(entry, np.int64)


def _scan32(maps, width):
    """Inclusive scan of the maps along the last axis by `shfl_up` rounds
    over `width` lanes, as the kernel's warps do."""
    inc = maps.copy()
    lane = np.arange(maps.shape[-1])
    d = 1
    while d < width:
        o = np.roll(inc, d, axis=-1)
        inc = np.where(lane >= d, _compose(o, inc), inc)
        d *= 2
    return inc


def _kernel_mirror(step, n, start, maps=16, seed=0):
    """csrc/orbit_resolve.cu step by step, every segment of 32 positions
    at once (a row of numpy arrays a thread): the codes and dead bits,
    the backward pass that gives each segment's map, the start's
    constant map, the general path of blocks with a live step above 4,
    the scans of each warp's 32 segments and of a tile's `maps` warp
    maps, the look-back with the tiles in a shuffled order, and the
    forward walks that mark. A tile is `maps` spans of 1024 positions in
    order: the kernel's two rounds of 8 warps make 16; fewer make more
    tiles of a cap, more make fewer."""
    cap = len(step)
    tile = maps * 32 * _SEG
    ntiles = -(-cap // tile)
    total = ntiles * tile
    s = np.ones(total, np.int64)
    s[:cap] = step
    nseg = total // _SEG
    base = np.arange(nseg, dtype=np.int64) * _SEG
    nrem = np.clip(n - base, -1, 1 << 30)
    raw = s.reshape(nseg, _SEG)
    sf = np.maximum(raw, 1)
    p = np.arange(_SEG)
    # the fast path: steps 1..4 and the segment's end 4 or more before n
    fast = ((raw >= 1) & (raw <= 4)).all(axis=1) & (nrem >= _SEG + 4)
    dead = (sf >= nrem[:, None] - p) & ~fast[:, None]
    big = ((sf > 4) & ~dead).any(axis=1)
    code = np.minimum(sf, 4) - 1

    w = np.full(nseg, _EXITS, np.int64)
    wb = np.full(nseg, 0x03020100, np.int64)  # the fast path's bytes
    for q in range(_SEG - 1, -1, -1):
        e = np.where(dead[:, q], _DEAD, (w >> (3 * code[:, q])) & 7)
        w = ((w << 3) | e) & 0xFFF
        wb = ((wb << 8) | ((wb >> (8 * code[:, q])) & 0xFF)) & 0xFFFFFFFF
    byte_map = ((wb & 7) | ((wb >> 5) & (7 << 3)) | ((wb >> 10) & (7 << 6))
                | ((wb >> 15) & (7 << 9)))
    seg_map = np.where(fast, byte_map, w) | (_DEAD << 12)

    def walk(a):  # a: bit p = the chain stands at p, one a segment
        reached = np.zeros((nseg, _SEG), bool)
        for q in range(_SEG):
            live = (a & ~dead[:, q] & 1).astype(np.int64)
            reached[:, q] = (a & 1).astype(bool)
            a = (a >> 1) | (live << code[:, q])
        low = a & -a
        ex = np.where(a > 0, np.log2(np.maximum(low, 1)).astype(np.int64),
                      _DEAD)
        return reached, ex

    ss, so = start // _SEG, start % _SEG
    a0 = np.zeros(nseg, np.int64)
    a0[ss] = 1 << so
    seg_map[ss] = _const(walk(a0)[1][ss])

    nblk = total // _B
    general = big.reshape(nblk, _B // _SEG).any(axis=1)
    sb = start // _B
    for k in np.flatnonzero(general):
        blk = s[k * _B:(k + 1) * _B]
        ex = [_walk_block(blk, k * _B, e, n) for e in range(4)]
        first = k * (_B // _SEG)
        seg_map[first:first + _B // _SEG] = _IDENT
        seg_map[first] = (_const(_walk_block(blk, k * _B, start % _B, n))
                          if k == sb else
                          ex[0] | ex[1] << 3 | ex[2] << 6 | ex[3] << 9
                          | _DEAD << 12)

    inc = _scan32(seg_map.reshape(-1, 32), 32)
    excl = np.roll(inc, 1, axis=1)
    excl[:, 0] = _IDENT
    wm = _scan32(inc[:, 31].reshape(ntiles, maps), maps)
    wex = np.roll(wm, 1, axis=1)
    wex[:, 0] = _IDENT
    entry = _look_back([int(m) for m in wm[:, -1]],
                       np.random.default_rng(seed))
    warp_entry = _apply(wex, entry[:, None]).reshape(-1)
    x = _apply(excl, warp_entry[:, None]).reshape(nseg)

    a = np.where(x < 4, 1 << np.minimum(x, 3), 0)
    a[ss] = 1 << so
    marks = walk(a)[0]
    for k in np.flatnonzero(general):
        blk_marks = np.zeros(_B, bool)
        xe = int(x[k * (_B // _SEG)])
        r = start % _B if k == sb else xe if xe < 4 else _B
        _walk_block(s[k * _B:(k + 1) * _B], k * _B, r, n, blk_marks)
        marks[k * (_B // _SEG):(k + 1) * (_B // _SEG)] = blk_marks.reshape(
            -1, _SEG)
    marks &= p < nrem[:, None]
    return marks.reshape(-1)[:cap]


def _stateful_steps(cap):
    """Steps like the lanes' on firmware: runs of 1 (zeros, 0xFF), of 2
    (two-byte text) and of 1..4 mixed."""
    rng = np.random.default_rng(5)
    step = np.ones(cap, np.int32)
    for o in range(0, cap, 3000):
        kind = (o // 3000) % 3
        if kind == 1:
            step[o:o + 3000] = 2
        elif kind == 2:
            step[o:o + 3000] = rng.integers(1, 5, len(step[o:o + 3000]))
    return step


# (cap, top step + 1, n, starts, warp maps a tile): caps over several
# tiles, more tiles than a look-back window (1 map: tiles of 1024), a
# start in the last tile, n = 0, n below the start, steps up to 8, ragged
# ends
_MIRROR_CASES = {
    "tiles": (110000, 5, None, (0, 3, 515, 600, 70000), 16),
    "tiles_of_one_round": (60000, 5, None, (0, 3, 20000), 8),
    "larger_tiles": (140000, 5, None, (0, 40000), 32),
    "window": (45000, 5, None, (0, 4, 9000), 1),
    "steps_up_to_8": (40000, 9, None, (0, 3, 515, 600), 16),
    "last_tile_start": (70000, 5, 70000, (69800, 69999, 65537), 16),
    "n_zero": (20000, 5, 0, (0, 7), 16),
    "n_below_start": (20000, 9, 9000, (9001, 12000, 600), 2),
    "ragged": (1500, 9, None, (0, 3, 515), 16),
    "stateful": (70001, 5, 70001, (0, 4), 16),
}


@pytest.mark.parametrize("case", sorted(_MIRROR_CASES))
def test_orbit_kernel_design_equals_the_plain_version(case):
    """The kernel's design, mirrored step by step, against its plain
    version `_orbit_mask_blocked_ref` (the reference's blocked resolve):
    a chain that leaves a block past offset 3 ends in both."""
    cap, top, n, starts, maps = _MIRROR_CASES[case]
    rng = np.random.default_rng(len(case))
    if case == "stateful":
        step = _stateful_steps(cap)
    else:
        step, n0 = _steps(rng, cap, top)
        n = n0 if n is None else n
    for k, start in enumerate(starts):
        want = TC._orbit_mask_blocked_ref(torch.from_numpy(step), n, start)
        got = _kernel_mirror(step, n, start, maps, seed=k)
        assert (got == want.numpy()).all(), (case, cap, n, start)
        if n > start:
            assert want.any(), (case, start)  # a chain to follow


def test_orbit_wrapper_checks_its_arguments():
    with pytest.raises(ValueError, match="int32"):
        TC._orbit_mask_blocked(torch.ones(2048, dtype=torch.int64), 10, 0)
    with pytest.raises(ValueError, match="start"):
        TC._orbit_mask_blocked(torch.ones(2048, dtype=torch.int32), 10, -1)
    got = TC._orbit_mask_blocked(torch.ones(2048, dtype=torch.int32), 2048,
                                 5000)
    assert not got.any() and got.shape == (2048,)


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


@pytest.mark.parametrize("flags", [{}, {"flag_unicode_block_filter": "All"}])
@pytest.mark.parametrize("enc", ["Big5", "EUC-JP", "EUC-KR", "GBK", "gb18030",
                                 "Shift_JIS"])
def test_feed_equals_the_reference_in_pieces(enc, flags):
    """Whole and in 1 KiB and 4 KiB pieces whose seams cut pairs, EUC-JP
    0x8F triples and gb18030 four-byte forms; extras included."""
    kind = de.encoding_kind(enc)
    n = 9001
    d = _planted(kind, n, seed=len(enc), seams=range(1024, n, 1024))
    m = Missions.new(flag_encoding=[enc], **flags).v[0]
    rm = RefMissions.new(flag_encoding=[enc], **flags).v[0]
    for extras in (False, True):
        want = jde.runtable_feed(d, rm, device=True, with_extras=extras)
        _same(jde.runtable_feed(d, rm, device=False, with_extras=extras),
              want, "reference host")
        assert want is not None
        for chunk in (1 << 26, 4096, 1024):
            got = de.runtable_feed(d, m, CPU, with_extras=extras, chunk=chunk)
            _same(got, want, f"{enc} extras={extras} chunk={chunk}")
        _same(de._feed_from_host_events(d, m, kind, extras), want, "oracle")


def test_feed_piece_carry_from_a_chain_past_the_seam():
    """A step that leaves a piece at each offset 0..3: a four-byte form
    ending 0..3 bytes into the next piece, at pieces of 62 bytes too."""
    m = Missions.new(flag_encoding=["gb18030"]).v[0]
    rm = RefMissions.new(flag_encoding=["gb18030"]).v[0]
    q = "\U0001F600".encode("gb18030")
    for k in range(4):
        d = np.frombuffer(b"a" * (1021 + k) + q * 3 + b" text " + q, np.uint8)
        want = jde.runtable_feed(d, rm, device=True, with_extras=True)
        for chunk in (1024, 62):
            _same(de.runtable_feed(d, m, CPU, with_extras=True, chunk=chunk),
                  want, (k, chunk))


def test_piece_feed_positions_past_2_gib():
    """The per-piece body at a base above 2**31: int64 positions equal
    the small-input result plus the base, for a chain kind and a
    self-synchronising one."""
    base = 2**31 + 5
    for enc in ("Big5", "UTF-8"):
        m = Missions.new(flag_encoding=[enc]).v[0]
        kind = de.encoding_kind(enc)
        d = (_planted("big5", 5000, seed=3) if kind == "big5"
             else np.frombuffer(("héllo wörld, " * 300).encode(), np.uint8))
        if kind == "big5":
            lanes, multi, hot = de._chain_piece_lanes(
                d, kind, 0, len(d), CPU, de._ChainState())
        else:
            lanes = de._halo_piece_lanes(d, kind, enc, 0, len(d), CPU)
            multi = hot = None
        af, ubf = filter_words(m)
        small = de._piece_feed(lanes, 0, -1, af, ubf, True, multi, hot)
        big = de._piece_feed(lanes, base, -1, af, ubf, True, multi, hot)
        assert len(small[0][0]) > 100
        assert len(small[1][0]) or kind != "big5"  # the multi-cp pairs
        for s, b in zip(small[0] + small[1], big[0] + big[1]):
            assert b.dtype == s.dtype
        for part in (0, 1):
            assert big[part][0].dtype == np.int64
            np.testing.assert_array_equal(big[part][0], small[part][0] + base)
            for s, b in zip(small[part][1:], big[part][1:]):
                np.testing.assert_array_equal(b, s)
        assert big[2] == small[2] + base


# ------------------------------------------------------------------- CLI


def _mixed(n=300 * 1024, seed=13):
    r = np.random.default_rng(seed)
    data = bytearray(r.integers(0, 256, n, np.uint8).tobytes())
    texts = [("国際化テスト 日本語 " * 30).encode("shift_jis"),
             ("你好世界 测试 \U0001F600 " * 30).encode("gb18030"),
             ("繁體中文測試 " * 30).encode("big5"),
             b"\x8f\xa2\xaf" + ("日本語のテキスト " * 30).encode("euc_jp"),
             ("안녕하세요 세계 " * 30).encode("euc-kr"),
             ("héllo wörld " * 50).encode("utf-8")]
    for k, off in enumerate(range(2048, n - 4096, 9001)):
        t = texts[k % len(texts)]
        data[off:off + len(t)] = t
    return bytes(data)


def _port_stream(argv, blob, chunk):
    args = parse_args(argv + ["-"])
    buf = io.BytesIO()
    assert port._run_streaming_stdin(args, Missions.from_args(args), buf,
                                     src=io.BytesIO(blob), chunk_bytes=chunk,
                                     device="cpu") == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["-e", "Shift_JIS", "-e", "gb18030", "-e", "UTF-8"],
    ["-e", "Big5", "-e", "EUC-JP", "-e", "EUC-KR", "-n", "2"],
    ["-e", "GBK", "-u", "All"],
])
def test_cli_feed_on_and_off_equal_the_reference(argv, tmp_path, monkeypatch):
    """Buffered and streamed, feed on and off, against the reference's
    engine=auto; with the feed on every CJK mission takes its feed."""
    monkeypatch.setenv("STRINGSEXT_DEVICE_PROBE", "0")
    blob = _mixed()
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    argv = ["-t", "x"] + argv
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
        assert _port_stream(argv, blob, 65536) == want, feed
        cjk = {de.encoding_kind(m.encoding_name)
               for m in Missions.from_args(parse_args(argv)).v} - {"utf8"}
        assert set(fed) == (cjk if feed == "1" else set()), fed


def test_feed_extras_cover_multi_cp_big5(tmp_path, monkeypatch):
    """tests/test_runtable_feed.py:381: the four Big5 double-codepoint
    pairs are excluded from the feed runs but stay hot."""
    pair = b"\x88\x62"  # U+00CA U+0304 (WHATWG big5 pointer 1133)
    cold = bytes(256) + b"ABCD" + bytes(256)
    blob = (bytes(8192) + b"\xa4\x40\xa4\x40" + pair + b"\xa4\x40\xa4\x40"
            + bytes(8192) + cold)
    p = tmp_path / "b.bin"
    p.write_bytes(blob)
    argv = ["-t", "x", "-e", "Big5", "-n", "2", str(p)]
    buf = io.BytesIO()
    assert ref_run.run(ref_parse_args(argv), out=buf, engine="auto") == 0
    monkeypatch.setenv("STRINGSEXT_RUNTABLE_FEED", "1")
    m = Missions.new(flag_encoding=["Big5"]).v[0]
    _feed, (ex_pos, _len) = de.runtable_feed(np.frombuffer(blob, np.uint8), m,
                                             CPU, with_extras=True)
    assert 8196 in ex_pos.tolist()  # the pair's lead
    out = io.BytesIO()
    assert port.run(parse_args(argv), out=out, device="cpu") == 0
    assert out.getvalue() == buf.getvalue()
    assert "Ê".encode() in out.getvalue()
