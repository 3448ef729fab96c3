"""Decode-event generation: byte stream -> (char | malformed) events.

This layer replaces the reference's streaming `encoding_rs` decoders
(used at reference/src/finding_collection.rs:139) with
*data-parallel classification*: for a whole in-memory byte buffer we
compute, per event, its input position, byte length, decoded codepoint
(or -1 for a malformed sequence) and the position of the byte whose
examination triggered/completed the event ("report point").

The event stream is a pure function of the bytes: it does not depend on
how the reference chops the stream into 4 KiB slices and 2*q-byte decode
windows. The windowing (which *is* observable in the output via
positions, precision tags and `+` continuations) is replayed exactly by
`stringsext_tpu.engine.automaton` on top of these events.

Event record arrays (parallel, one row per event, in stream order):
  pos     int64  byte offset of the first byte of the char/malformed seq
  in_len  int32  number of input bytes of the char / malformed sequence
  cp      int32  decoded Unicode codepoint; -1 for malformed
  report  int64  offset of the byte whose processing produced the event:
                 - char: offset of its last byte
                 - malformed: the byte that proved the sequence invalid
                   (== last byte for intrinsically-invalid sequences,
                   == the *following* byte for truncated sequences)

Semantics follow the WHATWG Encoding Standard decoders, which is what
`encoding_rs` implements (maximal-subpart error reporting for UTF-8,
lone-surrogate errors with unit pushback for UTF-16, ...).

Everything here is vectorized numpy: no per-byte Python loops. The same
classification logic is mirrored on-device in `stringsext_tpu.ops`.
"""

from __future__ import annotations

import numpy as np

from ..encodings import (
    KIND_BIG5,
    KIND_EUC_JP,
    KIND_EUC_KR,
    KIND_GB18030,
    KIND_ISO_2022_JP,
    KIND_REPLACEMENT,
    KIND_SHIFT_JIS,
    KIND_SINGLE_BYTE,
    KIND_UTF16BE,
    KIND_UTF16LE,
    KIND_UTF8,
    encoding_kind,
    full_byte_table,
)


class Events:
    """Struct-of-arrays event list.

    `pushback` is nonzero only for malformed events whose detection
    consumed lookahead bytes that are pushed back for re-decoding (e.g.
    the non-low-surrogate unit after a lone UTF-16 high surrogate, or the
    ASCII trail byte after a bad CJK lead). When the rewind is impossible
    because the lookahead spans a decode-call boundary, the decoder keeps
    those bytes internally and the next call's input offset advances past
    them; the automaton uses `pushback` to reproduce that.
    """

    __slots__ = ("pos", "in_len", "cp", "report", "pushback")

    def __init__(self, pos, in_len, cp, report, pushback=None):
        self.pos = np.asarray(pos, dtype=np.int64)
        self.in_len = np.asarray(in_len, dtype=np.int32)
        self.cp = np.asarray(cp, dtype=np.int32)
        self.report = np.asarray(report, dtype=np.int64)
        if pushback is None:
            pushback = np.zeros(len(self.pos), dtype=np.int32)
        self.pushback = np.asarray(pushback, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.pos)

    @staticmethod
    def concat(parts: "list[Events]") -> "Events":
        if not parts:
            z64, z32 = np.zeros(0, np.int64), np.zeros(0, np.int32)
            return Events(z64, z32, z32, z64, z32)
        return Events(
            np.concatenate([p.pos for p in parts]),
            np.concatenate([p.in_len for p in parts]),
            np.concatenate([p.cp for p in parts]),
            np.concatenate([p.report for p in parts]),
            np.concatenate([p.pushback for p in parts]),
        )


def generate_events(data: np.ndarray, encoding_name: str) -> Events:
    """Decode `data` (uint8 array, the complete stream) into events."""
    kind = encoding_kind(encoding_name)
    if kind == KIND_UTF8:
        return _utf8_events(data)
    if kind in (KIND_UTF16LE, KIND_UTF16BE):
        return _utf16_events(data, big_endian=(kind == KIND_UTF16BE))
    if kind == KIND_SINGLE_BYTE:
        return _single_byte_events(data, encoding_name)
    if kind == KIND_REPLACEMENT:
        # The replacement decoder reports one malformed for the whole
        # stream; it never yields characters, so no finding can ever
        # pass a length filter. Emit a single malformed covering byte 0.
        if len(data) == 0:
            return _empty_events()
        return Events([0], [1], [-1], [0])
    if kind in (KIND_BIG5, KIND_EUC_JP, KIND_EUC_KR, KIND_GB18030, KIND_SHIFT_JIS):
        from . import events_cjk

        return events_cjk.generate(data, kind)
    if kind == KIND_ISO_2022_JP:
        from . import events_iso2022

        return events_iso2022.generate(data)
    raise KeyError(kind)


def _empty_events() -> Events:
    return Events(
        np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int64)
    )


def _single_byte_events(data: np.ndarray, encoding_name: str) -> Events:
    """Single-byte encodings: every byte is one event."""
    n = len(data)
    if n == 0:
        return _empty_events()
    table = full_byte_table(encoding_name)
    cp = table[data]
    pos = np.arange(n, dtype=np.int64)
    in_len = np.ones(n, dtype=np.int32)
    return Events(pos, in_len, cp, pos)


def _utf8_events(data: np.ndarray) -> Events:
    """UTF-8 validity DFA, vectorized (cf. Keiser/Lemire, PAPERS.md).

    True event starts are computed without a sequential scan using the
    UTF-8 structural property that chars/malformed sequences only ever
    consume *continuation* bytes after their first byte: a non-cont byte
    is always an event start, and a cont byte is an event start iff it is
    not claimed by the event starting at the nearest preceding non-cont
    byte.
    """
    n = len(data)
    if n == 0:
        return _empty_events()
    b = data.astype(np.int32)
    # Pad lookahead with sentinel 0x00 (never a continuation byte).
    bp = np.concatenate([b, np.zeros(3, np.int32)])
    in_range = np.concatenate(
        [np.ones(n, bool), np.zeros(3, bool)]
    )  # whether bp[i] is a real byte

    cont = (bp >> 6) == 0b10  # 0x80..0xBF
    b1 = bp[1 : n + 1]
    b2 = bp[2 : n + 2]
    b3 = bp[3 : n + 3]
    c1 = cont[1 : n + 1] & in_range[1 : n + 1]
    c2 = cont[2 : n + 2] & in_range[2 : n + 2]
    c3 = cont[3 : n + 3] & in_range[3 : n + 3]
    have1 = in_range[1 : n + 1]
    have2 = in_range[2 : n + 2]
    have3 = in_range[3 : n + 3]

    bb = bp[:n]
    is_cont = cont[:n]
    lead1 = bb < 0x80
    lead2 = (bb >= 0xC2) & (bb <= 0xDF)
    lead3 = (bb >= 0xE0) & (bb <= 0xEF)
    lead4 = (bb >= 0xF0) & (bb <= 0xF4)
    # C0, C1, F5..FF are never valid anywhere.
    intrinsic_bad = ((bb >= 0xC0) & (bb <= 0xC1)) | (bb >= 0xF5)

    # First-continuation constraints (overlong / surrogate / range rules).
    c1ok3 = c1 & np.where(
        bb == 0xE0, (b1 >= 0xA0), np.where(bb == 0xED, (b1 <= 0x9F), True)
    )
    c1ok4 = c1 & np.where(
        bb == 0xF0, (b1 >= 0x90), np.where(bb == 0xF4, (b1 <= 0x8F), True)
    )

    valid2 = lead2 & c1
    valid3 = lead3 & c1ok3 & c2
    valid4 = lead4 & c1ok4 & c2 & c3

    # As-if-start event length and kind at every position.
    ev_len = np.ones(n, dtype=np.int32)
    ev_valid = lead1.copy()
    ev_len = np.where(valid2, 2, ev_len)
    ev_len = np.where(valid3, 3, ev_len)
    ev_len = np.where(valid4, 4, ev_len)
    ev_valid |= valid2 | valid3 | valid4

    # Maximal-subpart malformed lengths for invalid starts.
    bad_len = np.ones(n, dtype=np.int32)
    # lead3: lead+1cont consumed if first cont was acceptable.
    bad_len = np.where(lead3 & c1ok3 & ~c2, 2, bad_len)
    # lead4: consume the acceptable prefix.
    bad_len = np.where(lead4 & c1ok4 & ~c2, 2, bad_len)
    bad_len = np.where(lead4 & c1ok4 & c2 & ~c3, 3, bad_len)

    # Report point: intrinsically-invalid bytes and stray continuation
    # bytes report at themselves; truncated sequences report at the first
    # offending byte (pos + bad_len, not consumed).
    idx = np.arange(n, dtype=np.int64)
    trunc = (lead2 & ~c1) | (lead3 & ~(c1ok3 & c2)) | (lead4 & ~(c1ok4 & c2 & c3))
    ev_report = np.where(ev_valid, idx + ev_len - 1, idx)
    ev_report = np.where(~ev_valid & trunc, idx + bad_len, ev_report)

    # A truncated sequence at the very end of the stream stays pending in
    # the decoder and produces no event (the reference never flushes in
    # production; see SURVEY.md: input.rs:120-167 never yields is_last).
    # Truncation-pending: lead with all present bytes acceptable but
    # sequence extending past the end.
    pend2 = lead2 & ~have1
    pend3 = lead3 & ((~have1) | (c1ok3 & ~have2))
    pend4 = lead4 & ((~have1) | (c1ok4 & c1 & ~have2) | (c1ok4 & c2 & ~have3))
    # Note: for pend3/pend4 the first-cont check must have passed for the
    # sequence to stay pending; an unacceptable first cont is an error
    # even at stream end? No: the decoder cannot examine a byte it does
    # not have. If the byte is absent the sequence is pending; if present
    # and bad, it is a truncated malformed (handled above).
    pending = (pend2 | pend3 | pend4) & ~ev_valid

    ev_len = np.where(ev_valid, ev_len, bad_len)

    # True starts: non-cont bytes always; cont bytes iff not claimed by
    # the event at the nearest preceding non-cont byte.
    noncont_idx = np.where(~is_cont, idx, -1)
    prev_noncont = np.maximum.accumulate(noncont_idx)
    has_prev = prev_noncont >= 0
    pn = np.where(has_prev, prev_noncont, 0)
    # A pending (truncated-at-end) lead claims all its remaining bytes.
    claim_len = np.where(pending[pn], 4, ev_len[pn])
    claimed_until = np.where(has_prev, pn + claim_len - 1, -1)
    is_start = (~is_cont) | (idx > claimed_until)

    start_idx = np.flatnonzero(is_start)
    v = ev_valid[start_idx]
    p = pending[start_idx]
    keep = ~p  # pending events are dropped (no event materializes)
    start_idx = start_idx[keep]
    v = v[keep]

    lens = ev_len[start_idx]
    reports = ev_report[start_idx]

    # Decode codepoints for valid chars.
    s = start_idx
    cp = np.where(
        v,
        np.select(
            [lens == 1, lens == 2, lens == 3],
            [
                bb[s],
                ((bb[s] & 0x1F) << 6) | (bp[s + 1] & 0x3F),
                ((bb[s] & 0x0F) << 12) | ((bp[s + 1] & 0x3F) << 6) | (bp[s + 2] & 0x3F),
            ],
            ((bb[s] & 0x07) << 18)
            | ((bp[s + 1] & 0x3F) << 12)
            | ((bp[s + 2] & 0x3F) << 6)
            | (bp[s + 3] & 0x3F),
        ),
        -1,
    ).astype(np.int32)

    return Events(s.astype(np.int64), lens, cp, reports)


def _utf16_events(data: np.ndarray, big_endian: bool) -> Events:
    """UTF-16 (LE/BE) decode, vectorized.

    Code units are consecutive 2-byte groups from stream offset 0. A
    trailing odd byte stays pending forever (no flush in production).
    Surrogate pairing needs only 1-unit lookahead, so no sequential scan:
      pair_start[i]  = high[i] & low[i+1]
      lone_high[i]   = high[i] & ~low[i+1]   (reported at unit i+1: the
                       decoder must read the next unit to decide; that
                       unit is then pushed back and re-decoded)
      lone_low[i]    = low[i] & ~pair_start[i-1]  (intrinsic, reported at
                       unit i itself)
    A lone high surrogate in the *last* complete unit stays pending.
    """
    n = len(data)
    nu = n // 2
    if nu == 0:
        return _empty_events()
    d = data[: nu * 2].reshape(nu, 2).astype(np.int32)
    if big_endian:
        units = (d[:, 0] << 8) | d[:, 1]
    else:
        units = (d[:, 1] << 8) | d[:, 0]

    high = (units >= 0xD800) & (units <= 0xDBFF)
    low = (units >= 0xDC00) & (units <= 0xDFFF)
    low_next = np.concatenate([low[1:], [False]])
    have_next = np.concatenate([np.ones(nu - 1, bool), [False]])

    pair_start = high & low_next
    pair_trail = np.concatenate([[False], pair_start[:-1]])
    lone_high = high & ~low_next & have_next  # last-unit lone high: pending
    lone_low = low & ~pair_trail
    bmp = ~high & ~low

    # Event tables per unit index.
    uidx = np.arange(nu, dtype=np.int64)
    is_event = bmp | pair_start | lone_high | lone_low
    ev_units = np.flatnonzero(is_event)

    pos = ev_units.astype(np.int64) * 2
    is_pair = pair_start[ev_units]
    is_err = (lone_high | lone_low)[ev_units]
    in_len = np.where(is_pair, 4, 2).astype(np.int32)
    # cp: BMP unit, or astral from pair, or -1.
    nxt = np.concatenate([units[1:], [0]])
    astral = 0x10000 + ((units & 0x3FF) << 10) + (nxt & 0x3FF)
    cp = np.where(is_err, -1, np.where(is_pair, astral[ev_units], units[ev_units]))
    cp = cp.astype(np.int32)
    # malformed is always the 2 bytes of the surrogate unit itself.
    in_len = np.where(is_err, 2, in_len).astype(np.int32)

    # Report points (byte offsets):
    # - BMP char: last byte of unit.
    # - pair: last byte of trail unit.
    # - lone low: last byte of unit (intrinsic).
    # - lone high: last byte of the NEXT unit (lookahead, pushed back).
    report = pos + 1
    report = np.where(is_pair, pos + 3, report)
    report = np.where(lone_high[ev_units], pos + 3, report)
    pushback = np.where(lone_high[ev_units], 2, 0).astype(np.int32)

    return Events(pos, in_len, cp, report, pushback)
