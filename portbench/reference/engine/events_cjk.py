"""Decode-event generation for the CJK multi-byte encodings:
Big5, EUC-JP, EUC-KR, GBK/gb18030, Shift_JIS.

Replaces the encoding_rs CJK decoder state machines (SURVEY.md component
#10) with vectorized classification. Unlike UTF-8, these encodings are
not locally self-synchronizing (char boundaries inside a run of high
bytes depend on the run's start), so boundaries are resolved with a
pointer-jumping pass over a per-position "as-if-start" step table:
every position gets a local (bytes-only) consumed-length; the true event
starts are the orbit of position 0 under `i -> i + step[i]`, computed in
O(log n) vectorized rounds.

Decoder semantics follow the WHATWG Encoding Standard (what encoding_rs
implements): error pushback of ASCII trail bytes, gb18030 four-byte
handling, Shift_JIS 0x80 -> U+0080, EUC-JP 0x8E katakana / 0x8F
JIS X 0212 three-byte forms. Codepoint mappings come from the vendored
WHATWG index corpus (stringsext_tpu/encodings/whatwg_data.npz, see
encodings/whatwg.py and scripts/gen_whatwg_tables.py) — the same index
tables encoding_rs compiles in; no Python codec is consulted at
runtime.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from ..encodings import (
    KIND_BIG5,
    KIND_EUC_JP,
    KIND_EUC_KR,
    KIND_GB18030,
    KIND_SHIFT_JIS,
)
from .events import Events

@functools.lru_cache(maxsize=None)
def _pair_table(kind: str) -> Tuple[np.ndarray, Dict[int, Tuple[int, ...]]]:
    """(valid, multi) for two-byte sequences: `valid[lead, trail]` is
    True when the pair decodes; `multi` maps lead*256+trail to the
    decoded codepoints for the rare pairs that decode to more than one
    codepoint (four Big5 pointers per WHATWG). Sourced from the
    vendored WHATWG index corpus (encodings/whatwg.py)."""
    from ..encodings import whatwg

    cp = whatwg.pair_cp(kind)
    multi = whatwg.pair_multi(kind)
    valid = cp >= 0
    for key in multi:
        valid[key // 256, key % 256] = True
    return valid, multi


@functools.lru_cache(maxsize=None)
def _eucjp_0212_table() -> np.ndarray:
    """valid[t2, t3] for EUC-JP 0x8F three-byte (JIS X 0212) forms."""
    from ..encodings import whatwg

    return whatwg.jis0212_cp() >= 0


def _resolve_orbit(step: np.ndarray) -> np.ndarray:
    """True event-start positions: the orbit of 0 under i -> i+step[i].
    Vectorized pointer jumping, O(n log n)."""
    n = len(step)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    nxt = np.minimum(np.arange(n, dtype=np.int64) + step.astype(np.int64), n)
    J = np.append(nxt, n)  # sentinel: position n maps to itself
    marked = np.zeros(n + 1, dtype=bool)
    marked[0] = True
    prev = 0
    while True:
        marked[J[np.flatnonzero(marked)]] = True
        cnt = int(marked.sum())
        if cnt == prev:
            break
        prev = cnt
        J = J[J]  # doubling: J becomes next^(2^k)
    return np.flatnonzero(marked[:n])


class _Classified:
    """Per-position as-if-start classification (struct of arrays)."""

    def __init__(self, n: int):
        self.step = np.ones(n, dtype=np.int32)  # bytes consumed from input
        self.is_char = np.zeros(n, dtype=bool)  # direct char with .cp
        self.cp = np.full(n, -1, dtype=np.int32)
        self.needs_decode = np.zeros(n, dtype=bool)  # batch-decode bytes
        self.pending = np.zeros(n, dtype=bool)  # truncated at stream end
        self.report = np.zeros(n, dtype=np.int64)
        self.pushback = np.zeros(n, dtype=np.int32)
        self.in_len = np.ones(n, dtype=np.int32)  # event's input length


def generate(data: np.ndarray, kind: str) -> Events:
    n = len(data)
    if n == 0:
        return Events(
            np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int64), np.zeros(0, np.int32),
        )
    b = data.astype(np.int32)
    if kind == KIND_EUC_JP:
        c = _classify_eucjp(b)
    elif kind == KIND_GB18030:
        c = _classify_gb18030(b)
    else:
        c = _classify_two_byte(b, kind)

    starts = _resolve_orbit(c.step)
    keep = ~c.pending[starts]
    starts = starts[keep]

    pos = starts.astype(np.int64)
    in_len = c.in_len[starts]
    report = c.report[starts]
    pushback = c.pushback[starts]
    cp = c.cp[starts].copy()

    # Map the table-mapped sequences through the vendored WHATWG
    # indexes (vectorized gathers; no codec calls).
    nd = np.flatnonzero(c.needs_decode[starts])
    extra_rows = []
    if len(nd):
        from ..encodings import whatwg

        lens = in_len[nd]
        # Two-byte: pair_cp gather (covers every kind's 2-byte forms).
        m2 = lens == 2
        if m2.any():
            pt = whatwg.pair_cp(kind)
            i2 = nd[m2]
            cp[i2] = pt[data[starts[i2]], data[starts[i2] + 1]]
            _, multi = _pair_table(kind)
            if multi:
                keys = (data[starts[i2]].astype(np.int64) * 256
                        + data[starts[i2] + 1])
                for j, key in zip(i2, keys.tolist()):
                    if key in multi:
                        cps = multi[key]
                        cp[j] = cps[0]
                        for extra_cp in cps[1:]:
                            extra_rows.append(
                                (int(pos[j]), 0, extra_cp, int(report[j]), 0))
        # Three-byte (EUC-JP 0x8F + jis0212).
        m3 = lens == 3
        if m3.any():
            t0212 = whatwg.jis0212_cp()
            i3 = nd[m3]
            cp[i3] = t0212[data[starts[i3] + 1], data[starts[i3] + 2]]
        # Four-byte (gb18030 ranges).
        m4 = lens == 4
        if m4.any():
            rp, rc = whatwg.gb18030_ranges()
            i4 = nd[m4]
            q = [data[starts[i4] + k].astype(np.int64) for k in range(4)]
            p = ((q[0] - 0x81) * 12600 + (q[1] - 0x30) * 1260
                 + (q[2] - 0x81) * 10 + (q[3] - 0x30))
            k = np.searchsorted(rp, p, side="right") - 1
            cp[i4] = (rc[k].astype(np.int64) + (p - rp[k])).astype(np.int32)
        assert (cp[nd] >= 0).all(), "needs_decode event missing a mapping"

    ev = Events(pos, in_len, cp, report, pushback)
    if extra_rows:
        rows = sorted(
            [
                (int(ev.pos[i]), int(ev.in_len[i]), int(ev.cp[i]), int(ev.report[i]),
                 int(ev.pushback[i]), 0)
                for i in range(len(ev))
            ]
            + [(p, l, c_, r, pb, 1) for (p, l, c_, r, pb) in extra_rows],
            key=lambda t: (t[0], t[5]),
        )
        ev = Events(
            [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
            [r[3] for r in rows], [r[4] for r in rows],
        )
    # A byte pushed back by an error (e.g. the digit after a bad gb18030
    # four-byte form) is re-decoded only after the error was detected:
    # clamp reports to the running maximum so the stream matches the
    # sequential decoder's emission clock.
    if len(ev):
        ev.report = np.maximum.accumulate(ev.report)
    return ev


def _lookup2(valid: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """valid[b[i], b[i+1]] with False beyond the end."""
    t = np.concatenate([b[1:], np.zeros(1, np.int32)])[:n]
    v = valid[b, t]
    v[n - 1 :] = False
    return v


def _classify_two_byte(b: np.ndarray, kind: str) -> _Classified:
    """Big5 / EUC-KR / Shift_JIS: single bytes + lead/trail pairs with
    WHATWG error-pushback semantics."""
    n = len(b)
    c = _Classified(n)
    idx = np.arange(n, dtype=np.int64)
    valid, _multi = _pair_table(kind)

    if kind == KIND_SHIFT_JIS:
        single = b <= 0x80  # includes 0x80 -> U+0080 (WHATWG 13.3)
        kana = (b >= 0xA1) & (b <= 0xDF)
        lead = ((b >= 0x81) & (b <= 0x9F)) | ((b >= 0xE0) & (b <= 0xFC))
    elif kind == KIND_BIG5:
        single = b < 0x80
        kana = np.zeros(n, dtype=bool)
        lead = (b >= 0x81) & (b <= 0xFE)
    else:  # EUC-KR
        single = b < 0x80
        kana = np.zeros(n, dtype=bool)
        lead = (b >= 0x81) & (b <= 0xFE)

    # Defaults: 1-byte malformed (report at self).
    c.report[:] = idx

    # Single-byte chars.
    c.is_char |= single
    c.cp = np.where(single, b, c.cp)
    if kind == KIND_SHIFT_JIS:
        c.is_char |= kana
        c.cp = np.where(kana, 0xFF61 - 0xA1 + b, c.cp)

    # Pairs.
    t = np.concatenate([b[1:], np.zeros(1, np.int32)])[:n]
    have_t = np.arange(n) < n - 1
    pair_ok = _lookup2(valid, b, n) & lead
    trail_ascii = t < 0x80

    c.needs_decode |= pair_ok
    c.step = np.where(pair_ok, 2, c.step)
    c.in_len = np.where(pair_ok, 2, c.in_len)
    c.report = np.where(pair_ok, idx + 1, c.report)

    bad_pair = lead & have_t & ~pair_ok
    # ASCII trail: pushed back (malformed = lead only, 1 byte).
    pb = bad_pair & trail_ascii
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    # non-ASCII trail: consumed with the malformed (2 bytes).
    npb = bad_pair & ~trail_ascii
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)

    # Lead at stream end: pending.
    c.pending = lead & ~have_t
    c.step = np.where(c.pending, 1, c.step)
    return c


def _classify_eucjp(b: np.ndarray) -> _Classified:
    """EUC-JP (WHATWG 12.1): ASCII, 0x8E+kana, 0x8F+jis0212 three-byte,
    and A1-FE jis0208 pairs."""
    n = len(b)
    c = _Classified(n)
    idx = np.arange(n, dtype=np.int64)
    c.report[:] = idx

    t1 = np.concatenate([b[1:], np.zeros(1, np.int32)])[:n]
    t2 = np.concatenate([b[2:], np.zeros(2, np.int32)])[:n]
    have1 = np.arange(n) < n - 1
    have2 = np.arange(n) < n - 2

    ascii_ = b < 0x80
    c.is_char |= ascii_
    c.cp = np.where(ascii_, b, c.cp)

    # 0x8E + A1-DF: half-width katakana.
    is8e = b == 0x8E
    kana_ok = is8e & have1 & (t1 >= 0xA1) & (t1 <= 0xDF)
    c.is_char |= kana_ok
    c.cp = np.where(kana_ok, 0xFF61 - 0xA1 + t1, c.cp)
    c.step = np.where(kana_ok, 2, c.step)
    c.in_len = np.where(kana_ok, 2, c.in_len)
    c.report = np.where(kana_ok, idx + 1, c.report)
    bad8e = is8e & have1 & ~((t1 >= 0xA1) & (t1 <= 0xDF))
    pb = bad8e & (t1 < 0x80)
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad8e & ~(t1 < 0x80)
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)
    pend8e = is8e & ~have1

    # A1-FE + A1-FE: jis0208 pairs.
    valid08, _ = _pair_table(KIND_EUC_JP)
    lead = (b >= 0xA1) & (b <= 0xFE)
    pair_ok = lead & have1 & valid08[b, t1]
    c.needs_decode |= pair_ok
    c.step = np.where(pair_ok, 2, c.step)
    c.in_len = np.where(pair_ok, 2, c.in_len)
    c.report = np.where(pair_ok, idx + 1, c.report)
    bad_pair = lead & have1 & ~pair_ok
    pb = bad_pair & (t1 < 0x80)
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad_pair & ~(t1 < 0x80)
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)
    pend_lead = lead & ~have1

    # 0x8F + A1-FE + A1-FE: jis0212 three-byte.
    is8f = b == 0x8F
    v0212 = _eucjp_0212_table()
    second_ok = is8f & have1 & (t1 >= 0xA1) & (t1 <= 0xFE)
    tri_ok = second_ok & have2 & v0212[t1, t2]
    c.needs_decode |= tri_ok
    c.step = np.where(tri_ok, 3, c.step)
    c.in_len = np.where(tri_ok, 3, c.in_len)
    c.report = np.where(tri_ok, idx + 2, c.report)
    bad3 = second_ok & have2 & ~v0212[t1, t2]
    pb = bad3 & (t2 < 0x80)
    c.step = np.where(pb, 2, c.step)
    c.in_len = np.where(pb, 2, c.in_len)
    c.report = np.where(pb, idx + 2, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad3 & ~(t2 < 0x80)
    c.step = np.where(npb, 3, c.step)
    c.in_len = np.where(npb, 3, c.in_len)
    c.report = np.where(npb, idx + 2, c.report)
    bad2 = is8f & have1 & ~((t1 >= 0xA1) & (t1 <= 0xFE))
    pb = bad2 & (t1 < 0x80)
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad2 & ~(t1 < 0x80)
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)
    pend8f = (is8f & ~have1) | (second_ok & ~have2)

    c.pending = pend8e | pend_lead | pend8f
    # Pending sequences consume through the stream end (see gb18030
    # note; for EUC-JP the tail bytes are A1-FE and would cascade into
    # further pendings anyway, but make it explicit).
    c.step = np.where(c.pending, np.maximum(n - idx, 1).astype(np.int32), c.step)
    return c


def _classify_gb18030(b: np.ndarray) -> _Classified:
    """gb18030 / GBK (WHATWG 11: GBK's decoder is gb18030's decoder):
    two-byte pairs plus four-byte [81-FE][30-39][81-FE][30-39] forms."""
    n = len(b)
    c = _Classified(n)
    idx = np.arange(n, dtype=np.int64)
    c.report[:] = idx

    t1 = np.concatenate([b[1:], np.zeros(1, np.int32)])[:n]
    t2 = np.concatenate([b[2:], np.zeros(2, np.int32)])[:n]
    t3 = np.concatenate([b[3:], np.zeros(3, np.int32)])[:n]
    have1 = np.arange(n) < n - 1
    have2 = np.arange(n) < n - 2
    have3 = np.arange(n) < n - 3

    ascii_ = b < 0x80
    c.is_char |= ascii_
    c.cp = np.where(ascii_, b, c.cp)
    # WHATWG gb18030 decoder step 7 (the GBK euro quirk): 0x80 is a
    # valid 1-byte U+20AC, not an error.
    euro = b == 0x80
    c.is_char |= euro
    c.cp = np.where(euro, 0x20AC, c.cp)

    lead = (b >= 0x81) & (b <= 0xFE)
    digit1 = (t1 >= 0x30) & (t1 <= 0x39)
    two_range = (t1 >= 0x40) & (t1 <= 0xFE) & (t1 != 0x7F)

    # Two-byte pairs.
    valid2, _ = _pair_table(KIND_GB18030)
    pair_ok = lead & have1 & two_range & valid2[b, t1]
    c.needs_decode |= pair_ok
    c.step = np.where(pair_ok, 2, c.step)
    c.in_len = np.where(pair_ok, 2, c.in_len)
    c.report = np.where(pair_ok, idx + 1, c.report)
    bad_pair = lead & have1 & two_range & ~valid2[b, t1]
    pb = bad_pair & (t1 < 0x80)
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad_pair & ~(t1 < 0x80)
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)

    # Second byte outside both ranges: ASCII -> pushback, else consumed.
    bad2 = lead & have1 & ~digit1 & ~two_range
    pb = bad2 & (t1 < 0x80)
    c.report = np.where(pb, idx + 1, c.report)
    c.pushback = np.where(pb, 1, c.pushback)
    npb = bad2 & ~(t1 < 0x80)
    c.step = np.where(npb, 2, c.step)
    c.in_len = np.where(npb, 2, c.in_len)
    c.report = np.where(npb, idx + 1, c.report)

    # Four-byte forms.
    four_start = lead & have1 & digit1
    third_ok = (t2 >= 0x81) & (t2 <= 0xFE)
    fourth_ok = (t3 >= 0x30) & (t3 <= 0x39)
    f_all = four_start & have3 & third_ok & fourth_ok
    # Linear pointer; valid iff within the mapped ranges.
    p = (
        (b - 0x81) * 12600 + (t1 - 0x30) * 1260 + (t2 - 0x81) * 10 + (t3 - 0x30)
    )
    p_ok = (p <= 39419) | ((p >= 189000) & (p <= 1237575))
    quad_ok = f_all & p_ok
    c.needs_decode |= quad_ok
    c.step = np.where(quad_ok, 4, c.step)
    c.in_len = np.where(quad_ok, 4, c.in_len)
    c.report = np.where(quad_ok, idx + 3, c.report)
    quad_bad_ptr = f_all & ~p_ok  # all four consumed, no pushback
    c.step = np.where(quad_bad_ptr, 4, c.step)
    c.in_len = np.where(quad_bad_ptr, 4, c.in_len)
    c.report = np.where(quad_bad_ptr, idx + 3, c.report)
    # Third byte bad: prepend second+third (malformed = first byte).
    third_bad = four_start & have2 & ~third_ok
    c.report = np.where(third_bad, idx + 2, c.report)
    c.pushback = np.where(third_bad, 2, c.pushback)
    # Fourth byte bad: prepend second+third+fourth.
    fourth_bad = four_start & have3 & third_ok & ~fourth_ok
    c.report = np.where(fourth_bad, idx + 3, c.report)
    c.pushback = np.where(fourth_bad, 3, c.pushback)

    c.pending = (lead & ~have1) | (four_start & ~have2) | (
        four_start & have2 & third_ok & ~have3
    )
    # A pending (truncated) sequence has consumed every remaining byte
    # into the decoder: the orbit must not walk through its tail bytes
    # and emit phantom events from them.
    c.step = np.where(c.pending, np.maximum(n - idx, 1).astype(np.int32), c.step)
    return c
