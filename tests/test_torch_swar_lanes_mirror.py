"""A numpy mirror of the CUDA kernel `csrc/swar_lanes.cu`, thread by thread,
against the plain version `flagship_swar_lanes_ref`, on the CPU.

The kernel itself runs only on a card (chip_smoke.py holds it to the plain
version there). What can be checked without one is its arithmetic: every
function below repeats one function of `swar_lanes.cu`, `mission_fields.cuh`
or `byte_masks.cuh` line by line on arrays with one element a thread
(uint64 masked to 32 bits for the kernel's uint32, a warp shuffle as
`np.roll`, the first and last lane's own loads with their zero edge words),
reads the missions from the same packed table at the same offsets, and must
give the plain version's words exactly (tolerance 0: integer fields).
"""

import os
import re

import numpy as np
import pytest
import torch

from stringsext_tpu_torch import _build
from stringsext_tpu_torch.corpus import SWAR_LANES_FILTERS, swar_lanes_corpora
from stringsext_tpu_torch.mission import Missions
from stringsext_tpu_torch.ops import swar

M32 = np.uint64(0xFFFFFFFF)
OWN_BIT = 8  # kOwnBit
EVEN_BITS = np.uint64(0x55555555)  # kEvenBits


def _u(x):
    return np.asarray(x, np.uint64) & M32


def _not(x):
    return ~x & M32


def _shl(x, k):
    return (x << np.uint64(k)) & M32


def _shr(x, k):
    return x >> np.uint64(k)


# ---------------------------------------------------------- byte_masks.cuh


def plane8(a, b, k):
    lsb, gather = np.uint64(0x01010101), np.uint64(0x01020408)
    packed = (_shr(a, k) & lsb) | _shl(_shr(b, k) & lsb, 4)
    return _shr((packed * gather) & M32, 24)


def transpose8(a, b):
    for sh, mask in ((7, 0x00AA00AA), (14, 0x0000CCCC)):
        t = (a ^ _shr(a, sh)) & np.uint64(mask)
        a = a ^ t ^ _shl(t, sh)
        t = (b ^ _shr(b, sh)) & np.uint64(mask)
        b = b ^ t ^ _shl(t, sh)
    lo4, hi4 = np.uint64(0x0F0F0F0F), np.uint64(0xF0F0F0F0)
    t = (a & lo4) | (_shl(b, 4) & hi4)
    b = (_shr(a, 4) & lo4) | (b & hi4)
    return t, b


def utf8_structure(W):
    top2 = W[7] & W[6]
    top4 = top2 & W[5] & W[4]
    low0 = _not(W[3] | W[2] | W[1] | W[0])
    cont = W[7] & _not(W[6])
    l1 = _not(W[7])
    l2 = top2 & _not(W[5]) & (W[4] | W[3] | W[2] | W[1])
    l3 = top2 & W[5] & _not(W[4])
    l4 = top4 & _not(W[3]) & _not(W[2] & (W[1] | W[0]))
    xe0 = l3 & low0
    xed = l3 & W[3] & W[2] & _not(W[1]) & W[0]
    xf0 = top4 & low0
    xf4 = top4 & _not(W[3]) & W[2] & _not(W[1]) & _not(W[0])
    c1, c2, c3 = _shr(cont, 1), _shr(cont, 2), _shr(cont, 3)
    m5, m45 = _shr(W[5], 1), _shr(W[5] | W[4], 1)
    c1ok3 = c1 & _not((xe0 & _not(m5)) | (xed & m5))
    c1ok4 = c1 & _not((xf0 & _not(m45)) | (xf4 & m45))
    v2 = l2 & c1
    v3 = l3 & c1ok3 & c2
    v4 = l4 & c1ok4 & c2 & c3
    bad2 = ((l3 & c1ok3) | (l4 & c1ok4)) & _not(c2)
    bad3 = l4 & c1ok4 & c2 & _not(c3)
    ge2 = v2 | v3 | v4 | bad2 | bad3
    ge3 = v3 | v4 | bad3
    noncont = _not(cont)
    claimed = (_shl(noncont & ge2, 1) | _shl(noncont & ge3, 2)
               | _shl(noncont & v4, 3))
    is_start = _not(cont & claimed)
    s2 = is_start & (v2 | bad2)
    s3 = is_start & (v3 | bad3)
    s4 = is_start & v4
    s1 = is_start & _not(s2 | s3 | s4)
    return dict(is_start=is_start, ev_valid=l1 | v2 | v3 | v4,
                s1=s1, s2=s2, s3=s3, s4=s4)


def bytes_equal(W, v):
    if not 0 <= v <= 255:
        return np.zeros_like(W[0])
    e = np.full_like(W[0], M32)
    for k in range(8):
        e &= W[k] if (v >> k) & 1 else _not(W[k])
    return e


def utf16_structure(W, be):
    sur = W[7] & W[6] & _not(W[5]) & W[4] & W[3]
    hi_b, lo_b = sur & _not(W[2]), sur & W[2]
    hi = (hi_b if be else _shr(hi_b, 1)) & EVEN_BITS
    lo = (lo_b if be else _shr(lo_b, 1)) & EVEN_BITS
    pair = hi & _shr(lo, 2)
    trail = _shl(pair, 2)
    start = _not(trail) & EVEN_BITS
    valid = ((_not(hi) & _not(lo)) | pair) & start
    return dict(start=start, valid=valid, pair=pair)


# ------------------------------------------------------ mission_fields.cuh


def load_window_zero_edges(words):
    """c[0..5] of every thread; `words` is the flat stream of uint32."""
    nwords = len(words)
    w = _u(words)
    i = np.arange(nwords // 4)
    lane = i % 32
    c = [None] + [w[k::4].copy() for k in range(4)] + [None]
    c[0] = np.roll(c[4], 1)  # __shfl_up_sync(c[4], 1)
    c[5] = np.roll(c[1], -1)  # __shfl_down_sync(c[1], 1)
    first, last = lane == 0, lane == 31
    c[0][first] = np.where(i[first] == 0, 0, w[4 * i[first] - 1])
    at_end = 4 * i[last] + 4 == nwords
    c[5][last] = np.where(at_end, 0, w[np.where(at_end, 0, 4 * i[last] + 4)])
    return c


def byte_perm(a, b, sel):
    """__byte_perm(a, b, sel), selector nibbles 0-7 only."""
    src = a | _shl(np.asarray(b, np.uint64), 0) << np.uint64(32)
    out = np.zeros_like(a)
    for k in range(4):
        n = (sel >> (4 * k)) & 7
        out |= _shl(_shr(src, 8 * n) & np.uint64(0xFF), 8 * k)
    return out


def window_planes(c):
    t = [transpose8(c[2 * g], c[2 * g + 1]) for g in range(3)]
    W = []
    for k in range(8):
        x = [t[g][k >> 2] for g in range(3)]
        sel = (k & 3) | ((4 + (k & 3)) << 4)
        low16 = byte_perm(x[0], x[1], sel)
        window = (byte_perm(low16, x[2], 0x0010 | ((4 + (k & 3)) << 8))
                  & np.uint64(0x00FFFFFF))
        W.append(_shl(window, OWN_BIT - 4))
    return W


def byte_table_passes(c, table):
    passes = np.zeros_like(c[1])
    for i in range(15, -1, -1):
        v = _shr(c[1 + (i >> 2)], 8 * (i & 3)) & np.uint64(0xFF)
        passes = (np.uint64(2) * passes + table[v.astype(np.int64)]) & M32
    return _shl(passes, OWN_BIT)


def utf8_field_masks(W, passes, grep):
    u = utf8_structure(W)
    m0 = u["is_start"] & u["ev_valid"] & passes
    return [m0, u["s1"] | u["s3"], u["s2"] | u["s3"], u["s4"],
            m0 & bytes_equal(W, grep) if grep >= 0 else np.zeros_like(m0),
            u["is_start"], u["is_start"] & u["ev_valid"]]


def byte_perm_2301(x):
    """__byte_perm(x, 0, 0x2301): the two bytes of each half swapped."""
    ff = np.uint64(0x00FF00FF)
    return _shl(x & ff, 8) | (_shr(x, 8) & ff)


def utf16_interval_field_masks(c, W, be, astral, iv, niv, grep):
    s = utf16_structure(W, be)
    d = [byte_perm_2301(c[1 + k]) if be else c[1 + k] for k in range(5)]
    cp = [(_shr(d[j >> 1], 16 * (j & 1)) & np.uint64(0xFFFF)).astype(np.int64)
          for j in range(8)]
    if astral:
        for j in range(8):
            un = cp[j + 1] if j < 7 else (d[4] & np.uint64(0xFFFF)).astype(
                np.int64)
            is_pair = (_shr(s["pair"], OWN_BIT + 2 * j) & np.uint64(1)) != 0
            cp[j] = np.where(is_pair, 0x10000 + ((cp[j] & 0x3FF) << 10)
                             + (un & 0x3FF), cp[j])
    miss = [np.full_like(W[0], M32) for _ in range(8)]
    for k in range(0, niv, 2):
        lo0, hi0 = int(iv[2 * k]), int(iv[2 * k + 1])
        two = k + 1 < niv
        lo1, hi1 = (int(iv[2 * k + 2]), int(iv[2 * k + 3])) if two else (1, 0)
        for j in range(8):  # int32 arithmetic: wrap to 32 bits
            out0 = _u(cp[j] - lo0) | _u(hi0 - cp[j])
            out1 = _u(cp[j] - lo1) | _u(hi1 - cp[j])
            miss[j] &= out0 & out1
    missed = np.zeros_like(W[0])
    for j in range(7, -1, -1):  # __funnelshift_l(miss[j], missed, 2)
        missed = _shl(missed, 2) | _shr(miss[j], 30)
    passes = _not(_shl(missed, OWN_BIT))
    grep_hit = np.zeros_like(W[0])
    if grep >= 0:
        for j in range(8):
            grep_hit |= np.where(cp[j] == grep,
                                 np.uint64(1 << (OWN_BIT + 2 * j)),
                                 np.uint64(0))
    m0 = s["valid"] & passes
    return [m0, np.zeros_like(m0), s["start"] & _not(s["pair"]),
            s["start"] & s["pair"], m0 & grep_hit, s["start"], s["valid"]]


def field_words(m):
    zero = np.zeros_like(m[0])
    p01 = byte_perm(m[0], m[1], 0x6251)
    p23 = byte_perm(m[2], m[3], 0x6251)
    p45 = byte_perm(m[4], m[5], 0x6251)
    p6 = byte_perm(m[6], zero, 0x6251)
    v0, v1 = transpose8(byte_perm(p01, p23, 0x5410), byte_perm(p45, p6, 0x5410))
    v2, v3 = transpose8(byte_perm(p01, p23, 0x7632), byte_perm(p45, p6, 0x7632))
    return [v0, v1, v2, v3]


# ------------------------------------------------------------ swar_lanes.cu


def kernel_mirror(words_2d: np.ndarray, table: np.ndarray):
    """flagship_swar_lanes_kernel over every thread at once: `table` is
    the trio's packed records, as the kernel gets them."""
    rec = np.asarray(table, np.int32).reshape(-1)
    k_rec, k_hdr, k_tab_a = swar._REC, swar._HDR, swar.T_A
    c = load_window_zero_edges(words_2d.reshape(-1).view(np.uint32))
    W = window_planes(c)
    r8, rle, rbe = rec[:k_rec], rec[k_rec:2 * k_rec], rec[2 * k_rec:3 * k_rec]
    v = np.arange(256)
    pass8 = (_u(r8[k_tab_a:k_tab_a + 8].view(np.uint32))[v >> 5]
             >> (v & 31).astype(np.uint64)) & np.uint64(1)
    f8 = utf8_field_masks(W, byte_table_passes(c, pass8), int(r8[swar.H_GREP]))
    le, be = (utf16_interval_field_masks(
        c, W, big, bool(r[swar.H_ASTRAL]), r[k_hdr:], int(r[swar.H_NA]),
        int(r[swar.H_GREP])) for big, r in ((False, rle), (True, rbe)))
    m16 = [le[b] | _shl(be[b], 1) for b in range(7)]
    out = np.zeros((3, len(c[1]), 4), np.uint32)
    v8, v16 = field_words(f8), field_words(m16)
    for q in range(4):
        out[0, :, q] = v8[q]
        out[1, :, q] = v16[q] & np.uint64(0x00FF00FF)
        out[2, :, q] = _shr(v16[q], 8) & np.uint64(0x00FF00FF)
    return out.view(np.int32).reshape((3,) + words_2d.shape)


def test_transpose8_gives_the_planes_of_plane8():
    rng = np.random.default_rng(8)
    a, b = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64) for _ in range(2))
    lo, hi = transpose8(a, b)
    for k in range(8):
        got = _shr((lo, hi)[k >> 2], 8 * (k & 3)) & np.uint64(0xFF)
        np.testing.assert_array_equal(got, plane8(a, b, k))


def _params(name):
    ms = Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"],
                      **SWAR_LANES_FILTERS[name]).v
    return swar.swar_params(ms)


def _corpora():
    out = dict(swar_lanes_corpora())
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 40 * 512, dtype=np.uint8)
    text = "text ? déjà vu €uro \U0001F600 \U0001D11E"
    for k, codec in enumerate(("utf-8", "utf-16-le", "utf-16-be")):
        t = np.frombuffer((text * 3).encode(codec), np.uint8)
        for off in (1000 + 4096 * k, 2001 + 4096 * k, 16 * 512 - 7 + 512 * k):
            raw[off:off + len(t)] = t
    raw[-1] = 0xC3  # a lead byte at the very end: its trail is virtual
    raw[:2] = (0x00, 0xDC)  # a low surrogate that nothing precedes
    out["random-40-rows"] = raw
    out["byte-pairs"] = np.array([[i, j] for i in range(256)
                                  for j in range(256)], np.uint8).reshape(-1)
    out["all-0xFF-2-rows"] = np.full(1024, 0xFF, np.uint8)
    out["all-0x00-1-row"] = np.zeros(512, np.uint8)
    return out


CORPORA = _corpora()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("name", sorted(SWAR_LANES_FILTERS))
def test_kernel_mirror_equals_the_plain_version(name, corpus):
    p = _params(name)
    words = CORPORA[corpus].view(np.int32).reshape(-1, 128)
    table = swar.pack_specs(swar.flagship_specs(**p))
    got = kernel_mirror(words, table)
    want = swar.flagship_swar_lanes_ref(torch.from_numpy(words), **p)
    for mi in range(3):
        np.testing.assert_array_equal(got[mi], want[mi].numpy(),
                                      err_msg=f"mission {mi}")
    if corpus.startswith("seams-utf-16") and name in ("astral", "surrogates"):
        # the pairs across the seams: U+1D11E passes the astral filter, and
        # under the filter that covers the surrogates it must not pass as
        # its raw high unit
        f = got[1 if "-le-" in corpus else 2].view(np.uint8)
        pairs = (f & 0b1000) != 0
        assert pairs.sum() >= 31
        assert ((f[pairs] & 1) != 0).all() == (name == "astral")
        assert ((f[pairs] & 1) != 0).any() == (name == "astral")


def test_filter_sets_reach_what_they_are_named_for():
    recs = {name: swar.spec_records(swar.pack_specs(
        swar.flagship_specs(**_params(name)))) for name in SWAR_LANES_FILTERS}
    assert not any(r.astral for r in recs["flagship"] + recs["grep"])
    assert recs["astral"][1].astral and recs["astral"][1].lens & 0b1000
    assert recs["surrogates"][1].astral
    assert not recs["surrogates"][1].lens & 0b1000
    assert len(recs["twelve"][1].a) == len(recs["twelve"][2].a) == 12
    assert len(recs["twelve"][0].a) + len(recs["twelve"][0].b) == 12
    assert recs["grep"][0].grep == recs["twelve"][2].grep == 63


@pytest.mark.parametrize("source", ["swar_counts.cu", "swar_lanes.cu"])
def test_kernel_sources_declare_the_table_layout(source):
    """Both sources that read the packed table name its layout as
    constants; they must be swar.py's."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()

    def const(name):
        m = re.search(rf"\b{name} = ([^;,]+)[;,]", text)
        assert m, f"{source} does not declare {name}"
        return m.group(1).strip()

    assert int(const("kRec")) == swar._REC
    assert int(const("kHdr")) == swar._HDR
    assert int(const("kMaxIv")) == swar._MAX_IV
    assert const("kTabA") == "kHdr + 4 * kMaxIv"
    assert swar.T_A == swar._HDR + 4 * swar._MAX_IV
    for c_name, value in (("hAstral", swar.H_ASTRAL), ("hGrep", swar.H_GREP),
                          ("hNa", swar.H_NA)):
        assert int(const(c_name)) == value


@pytest.mark.parametrize("iv", [((0, 1 << 30),), ((-1, 5),)])
def test_pack_specs_refuses_bounds_the_sign_test_cannot_take(iv):
    """The kernel tests cp in [lo, hi] by the signs of cp - lo and hi - cp,
    which holds while the bounds lie in [0, 2**30)."""
    with pytest.raises(ValueError, match="interval bound"):
        swar.pack_specs((("utf16", False, iv, -1),))
    swar.pack_specs((("utf16", False, ((0, (1 << 30) - 1),), -1),))
