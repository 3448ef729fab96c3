"""Decode-event generation for ISO-2022-JP (WHATWG 12.2).

ISO-2022-JP is modal (escape sequences switch between ASCII / Roman /
half-width-katakana / JIS X 0208 two-byte modes), so unlike the other
encodings its events cannot be computed position-independently. The
escape bytes (0x1B) are rare, so the stream is split at them and each
inter-escape segment is decoded vectorized for its mode; only the
escape transitions themselves are handled sequentially.

Mode semantics and the redundant-escape "output flag" error follow the
WHATWG decoder (what encoding_rs implements).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..encodings import KIND_EUC_JP
from .events import Events
from .events_cjk import _pair_table

# Modes (the decoder's "output state").
ASCII = 0
ROMAN = 1
KATAKANA = 2
LEAD = 3  # JIS X 0208 two-byte mode


class _Acc:
    def __init__(self):
        self.pos: List[int] = []
        self.in_len: List[int] = []
        self.cp: List[int] = []
        self.report: List[int] = []
        self.pushback: List[int] = []

    def add(self, pos, in_len, cp, report, pushback=0):
        self.pos.append(pos)
        self.in_len.append(in_len)
        self.cp.append(cp)
        self.report.append(report)
        self.pushback.append(pushback)

    def add_many(self, pos, in_len, cp, report):
        self.pos.extend(pos.tolist())
        self.in_len.extend(in_len.tolist())
        self.cp.extend(cp.tolist())
        self.report.extend(report.tolist())
        self.pushback.extend([0] * len(pos))


def _decode_segment(acc: _Acc, b: np.ndarray, start: int, end: int, mode: int) -> bool:
    """Decode b[start:end] (no 0x1B inside) in `mode`; events carry
    absolute positions. Returns True if any char was emitted (clears the
    output flag)."""
    if end <= start:
        return False
    seg = b[start:end]
    idx = np.arange(start, end, dtype=np.int64)
    emitted = False

    if mode in (ASCII, ROMAN):
        ok = (seg < 0x80) & (seg != 0x0E) & (seg != 0x0F)
        cp = seg.astype(np.int32)
        if mode == ROMAN:
            cp = np.where(seg == 0x5C, 0x00A5, cp)
            cp = np.where(seg == 0x7E, 0x203E, cp)
        cp = np.where(ok, cp, -1)
        acc.add_many(idx, np.ones(len(seg), np.int32), cp, idx)
        emitted = bool(ok.any())
    elif mode == KATAKANA:
        ok = (seg >= 0x21) & (seg <= 0x5F)
        cp = np.where(ok, 0xFF61 - 0x21 + seg, -1).astype(np.int32)
        acc.add_many(idx, np.ones(len(seg), np.int32), cp, idx)
        emitted = bool(ok.any())
    else:  # LEAD: two-byte jis0208 pairs
        raise AssertionError("LEAD segments go through _decode_lead_segment")
    return emitted


def _decode_lead_segment(
    acc: _Acc, b: np.ndarray, start: int, end: int, esc_follows: bool
) -> bool:
    """Decode a LEAD-mode segment (no 0x1B inside).

    A byte left pending in trail-byte state at the segment end becomes
    an error when an escape follows (WHATWG trail-byte state on 0x1B),
    reported at the escape; at the true stream end it stays pending.
    Bad (out-of-range) bytes shift pair parity, so the vectorized path
    applies only when every byte is in 0x21-0x7E.
    """
    if end <= start:
        return False
    seg = b[start:end]
    n = len(seg)
    valid08, _ = _pair_table(KIND_EUC_JP)
    emitted = False

    if bool(((seg >= 0x21) & (seg <= 0x7E)).all()):
        npairs = n // 2
        if npairs:
            lead_idx = np.arange(0, 2 * npairs, 2)
            l = seg[lead_idx]
            t = seg[lead_idx + 1]
            pair_ok = valid08[(l | 0x80), (t | 0x80)]
            cp = np.full(npairs, -1, dtype=np.int32)
            vi = np.flatnonzero(pair_ok)
            if len(vi):
                # WHATWG 12.2.2: iso-2022-jp double-byte maps through
                # index jis0208 (the vendored euc-jp pair plane).
                from ..encodings import whatwg

                pt = whatwg.pair_cp(KIND_EUC_JP)
                cp[vi] = pt[(l[vi] | 0x80), (t[vi] | 0x80)]
                emitted = True
            idx = start + lead_idx.astype(np.int64)
            acc.add_many(idx, np.full(npairs, 2, np.int32), cp, idx + 1)
        if n % 2 == 1 and esc_follows:
            acc.add(start + n - 1, 1, -1, end)  # trail state hit by ESC
        return emitted

    # Scalar walk (bad bytes shift parity).
    i = 0
    while i < n:
        l = int(seg[i])
        if not (0x21 <= l <= 0x7E):
            acc.add(start + i, 1, -1, start + i)
            i += 1
            continue
        if i + 1 >= n:
            if esc_follows:
                acc.add(start + i, 1, -1, end)  # trail state hit by ESC
            return emitted  # else: pending at stream end
        t = int(seg[i + 1])
        if 0x21 <= t <= 0x7E and valid08[l | 0x80, t | 0x80]:
            from ..encodings import whatwg

            cp = int(whatwg.pair_cp(KIND_EUC_JP)[l | 0x80, t | 0x80])
            acc.add(start + i, 2, cp, start + i + 1)
            emitted = True
        else:
            acc.add(start + i, 2, -1, start + i + 1)
        i += 2
    return emitted


def generate(data: np.ndarray) -> Events:
    n = len(data)
    b = data.astype(np.int32)
    acc = _Acc()
    esc_positions = np.flatnonzero(b == 0x1B)

    mode = ASCII
    output_flag = False
    pos = 0
    ei = 0
    while pos < n:
        # Find the next escape at or after pos.
        while ei < len(esc_positions) and esc_positions[ei] < pos:
            ei += 1
        esc = int(esc_positions[ei]) if ei < len(esc_positions) else n

        # Decode the segment before the escape in the current mode.
        seg_end = esc
        if mode == LEAD:
            _decode_lead_segment(acc, b, pos, seg_end, seg_end < n)
        else:
            _decode_segment(acc, b, pos, seg_end, mode)
        if seg_end > pos:
            # WHATWG: every consumed data-state byte unsets the output
            # flag - error bytes included - so the redundant-escape
            # error fires only for two escapes with NOTHING between.
            output_flag = False

        if esc >= n:
            break
        # Process the escape sequence (sequential; escapes are rare).
        if esc + 1 >= n:
            break  # ESC pending at stream end
        e1 = int(b[esc + 1])
        if e1 not in (0x24, 0x28):
            # Invalid: error covers ESC; e1 is pushed back.
            acc.add(esc, 1, -1, esc + 1, pushback=1)
            pos = esc + 1
            continue
        if esc + 2 >= n:
            break  # ESC $ / ESC ( pending at stream end
        e2 = int(b[esc + 2])
        new_mode = None
        if e1 == 0x28:
            new_mode = {0x42: ASCII, 0x4A: ROMAN, 0x49: KATAKANA}.get(e2)
        else:  # 0x24
            new_mode = LEAD if e2 in (0x40, 0x42) else None
        if new_mode is None:
            # Invalid: error covers ESC; e1,e2 pushed back.
            acc.add(esc, 1, -1, esc + 2, pushback=2)
            pos = esc + 1
            continue
        was = output_flag
        output_flag = True
        mode = new_mode
        pos = esc + 3
        if was:
            # Redundant escape (no char since the last one): error
            # covering the whole sequence (WHATWG output flag).
            acc.add(esc, 3, -1, esc + 2)

    # Events are appended in true decode order (segments, then escape
    # events, then re-decoded pushback bytes). Reports must be
    # non-decreasing along that order: a pushed-back byte only becomes
    # available at the moment the invalid escape was detected, so clamp
    # each report to the running maximum (matching the sequential
    # decoder's emission clock).
    ev = Events(acc.pos, acc.in_len, acc.cp, acc.report, acc.pushback)
    ev.report = np.maximum.accumulate(ev.report) if len(ev) else ev.report
    return ev
