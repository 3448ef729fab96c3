"""Exact output lines of the reference CLI over regions of one image.

The reference CLI reads its input in 4096-byte slices, cuts each into
decode windows and carries three things from slice to slice: the
decoder's pending bytes (for ISO-2022-JP also its mode), a short run of
characters that touched the window's right edge, and the flag that the
last printed run may continue. A region of the image can be scanned on
its own, with nothing carried in, exactly when all three are empty at
its start in every history of the bytes before it. `calm_boundaries`
finds the slice boundaries P where that is so for every mission:

- the byte (UTF-16: the unit) before P leaves every decoder of the
  mission set with nothing pending, whatever came before it, and is a
  malformed sequence or a character that the mission's filter rejects,
  so no run touches the right edge of the last window and nothing is
  carried;
- the carried flag is empty or harmless: no stretch of bytes (UTF-16:
  units) that could each belong to an accepted character, as long as a
  whole output line, ends in the last decode window before P (only a
  run of a whole line's length is printed as possibly cut when the last
  character before P is rejected), or else the byte (unit) at P is
  decoded alike by the carried and a fresh decoder and is again
  malformed or rejected, so the flag cannot join the first run to the
  previous one.

ISO-2022-JP keeps its mode across any gap; the mode at P is that of the
last complete escape sequence before it (an ESC always starts an escape
in the WHATWG decoder, so a complete sequence is always obeyed), and a
region that starts in another mode than ASCII is scanned after a
4096-byte prefix slice that sets it.

Between two calm boundaries the region's lines are exactly the lines of
the whole scan whose offsets lie in the region. `region_lines(...,
carry=False)` scans every decode window as a stream of its own instead:
the control, which breaks the guarantee that a string is found whole
across the reference CLI's windows and slices (the shortcut that would
let an emitter run its windows in parallel), and which the comparison
must catch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np

from .encodings import (
    KIND_BIG5,
    KIND_EUC_JP,
    KIND_EUC_KR,
    KIND_GB18030,
    KIND_ISO_2022_JP,
    KIND_SHIFT_JIS,
    KIND_SINGLE_BYTE,
    KIND_UTF8,
    KIND_UTF16BE,
    KIND_UTF16LE,
    encoding_kind,
    full_byte_table,
)
from .engine.automaton import SliceScanner, utf8_lead
from .engine.events import generate_events
from .mission import Missions
from .options import Args, Radix

SLICE = 4096  # the reference CLI's input slice (input.rs:22)

_CJK = (KIND_BIG5, KIND_EUC_JP, KIND_EUC_KR, KIND_GB18030, KIND_SHIFT_JIS)

# ISO-2022-JP modes and the escape sequences that set them.
ISO_ASCII, ISO_ROMAN, ISO_KATAKANA, ISO_LEAD = 0, 1, 2, 3
_ISO_ESCAPES = {
    (0x28, 0x42): ISO_ASCII, (0x28, 0x4A): ISO_ROMAN,
    (0x28, 0x49): ISO_KATAKANA, (0x24, 0x40): ISO_LEAD,
    (0x24, 0x42): ISO_LEAD,
}
_ISO_PREFIX = {ISO_ROMAN: b"\x1b(J", ISO_KATAKANA: b"\x1b(I",
               ISO_LEAD: b"\x1b$B"}


def parse_argv(argv: Sequence[str]) -> Args:
    """The stringsext flags of a configuration's argv as the reference's
    `Args` (the input is added by the caller). Flags of the port's own
    that change no output (`--stream-file-min N`) are skipped."""
    args = Args()
    takes = {"-e": "encoding", "-a": "ascii_filter", "-g": "grep_char",
             "-n": "chars_min", "-q": "output_line_len",
             "-s": "counter_offset", "-u": "unicode_block_filter"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-t":
            args.radix = Radix(argv[i + 1])
            i += 2
        elif a in takes:
            if a == "-e":
                args.encoding.append(argv[i + 1])
            else:
                setattr(args, takes[a], argv[i + 1])
            i += 2
        elif a == "-r":
            args.same_unicode_block = True
            i += 1
        elif a == "--stream-file-min":
            i += 2
        else:
            raise ValueError(f"reference: flag {a!r} is not supported")
    return args


def _passes(mission, cp: int) -> bool:
    f = mission.filter
    if cp < 0x80:
        return f.pass_af_filter(cp)
    return f.pass_ubf_filter(utf8_lead(cp))


def _byte_ok(mission, kind: str) -> np.ndarray:
    """bool[256]: bytes that, in this mission's decoder, leave nothing
    pending whatever came before and give a malformed sequence or a
    character the filter rejects."""
    ok = np.zeros(256, bool)
    ctrl = [b for b in range(0x20) if not _passes(mission, b)]
    if kind == KIND_UTF8:
        ok[ctrl] = True
        ok[[0x7F]] = not _passes(mission, 0x7F)
        ok[[0xC0, 0xC1]] = True
        ok[0xF5:] = True
    elif kind in _CJK:
        ok[ctrl] = True
        ok[0xFF] = True
    elif kind == KIND_ISO_2022_JP:
        ok[[b for b in ctrl if b not in (0x0E, 0x0F, 0x1B)]] = True
        ok[0x80:] = True
    elif kind == KIND_SINGLE_BYTE:
        table = full_byte_table(mission.encoding_name)
        ok[:] = [int(c) < 0 or not _passes(mission, int(c)) for c in table]
    else:
        raise ValueError(f"reference: no calm-boundary rule for {kind}")
    return ok


def _unit(first, second, kind: str):
    """The UTF-16 unit of the int64 byte arrays `first` and `second` (the
    unit's first and second byte)."""
    if kind == KIND_UTF16LE:
        return first | (second << 8)
    return (first << 8) | second


def _maybe_accepted(mission, kind: str) -> np.ndarray:
    """bool[256] (UTF-16: [65536]): bytes (units) that could belong to a
    character the filter accepts, in some decoder state."""
    if kind in (KIND_UTF16LE, KIND_UTF16BE):
        maybe = ~_unit_ok(mission)
        maybe[0xD800:0xE000] = True
        return maybe
    if kind == KIND_UTF8:
        maybe = np.array([b >= 0x80 or _passes(mission, b)
                          for b in range(256)])
        maybe[[0xC0, 0xC1]] = False
        maybe[0xF5:] = False
        return maybe
    return ~_byte_ok(mission, kind)


def _flag_free(mission, kind: str, data: np.ndarray, p: np.ndarray):
    """bool per boundary in `p`: no stretch of possibly accepted bytes
    (units) as long as a whole output line ends in the decode window
    before it, so the run printed last there cannot have been cut."""
    line = mission.output_line_char_nb_max
    unit = 2 if kind in (KIND_UTF16LE, KIND_UTF16BE) else 1
    span = 2 * line + line * unit
    lo = p - span
    free = np.zeros(len(p), bool)
    inside = lo >= 0
    cols = np.arange(span, dtype=np.int64)
    block = data[lo[inside][:, None] + cols].astype(np.int64)
    if unit == 2:
        block = _unit(block[:, 0::2], block[:, 1::2], kind)
    maybe = _maybe_accepted(mission, kind)[block]
    c = np.cumsum(maybe, axis=1)
    reset = np.maximum.accumulate(np.where(maybe, 0, c), axis=1)
    free[inside] = (c - reset).max(axis=1) < line
    return free


@functools.lru_cache(maxsize=None)
def _unit_ok(mission) -> np.ndarray:
    """bool[65536]: UTF-16 units that are no surrogate and that the
    filter rejects (a lone low surrogate at P is malformed too)."""
    ok = np.array([not _passes(mission, u) for u in range(0x10000)], bool)
    ok[0xD800:0xE000] = False
    return ok


class Reference:
    """The reference's missions for one configuration's argv."""

    def __init__(self, argv: Sequence[str]):
        self.args = parse_argv(argv)
        self.args.inputs = ["image"]
        self.missions = Missions.from_args(self.args)
        self.kinds = [encoding_kind(m.encoding_name) for m in self.missions]

    def calm_boundaries(self, data: np.ndarray) -> np.ndarray:
        """int64 sorted: 0, every calm slice boundary, and len(data)."""
        n = len(data)
        p = np.arange(SLICE, n - 1, SLICE, dtype=np.int64)
        good = np.ones(len(p), bool)
        b = data.astype(np.int64)
        for m, kind in zip(self.missions, self.kinds):
            if kind in (KIND_UTF16LE, KIND_UTF16BE):
                ok = _unit_ok(m)
                before = _unit(b[p - 2], b[p - 1], kind)
                at = _unit(b[p], b[p + 1], kind)
                at_ok = ok[at] | ((at >= 0xDC00) & (at < 0xE000))
                before_ok = ok[before]
            else:
                ok = _byte_ok(m, kind)
                before_ok, at_ok = ok[b[p - 1]], ok[b[p]]
            good &= before_ok
            ask = np.flatnonzero(good & ~at_ok)
            if len(ask):
                good[ask] = _flag_free(m, kind, data, p[ask])
        return np.concatenate([[0], p[good], [n]]).astype(np.int64)

    @staticmethod
    def iso_modes(data: np.ndarray, points: np.ndarray) -> np.ndarray:
        """The ISO-2022-JP mode at each of `points`: that of the last
        complete escape sequence ending before it, ASCII if none."""
        esc = np.flatnonzero(data[:-2] == 0x1B)
        t, modes = [], []
        for k in esc.tolist():
            mode = _ISO_ESCAPES.get((int(data[k + 1]), int(data[k + 2])))
            if mode is not None:
                t.append(k + 2)
                modes.append(mode)
        if not t:
            return np.zeros(len(points), np.int64)
        idx = np.searchsorted(np.asarray(t), points, side="left") - 1
        return np.where(idx >= 0, np.asarray(modes)[np.maximum(idx, 0)],
                        ISO_ASCII)

    def region_findings(self, data: np.ndarray, lo: int, hi: int,
                        carry: bool = True) -> list:
        """The findings whose offsets lie in [lo, hi), lo and hi calm
        boundaries, sorted as the reference merges them (offset, then
        mission); with `carry` False every decode window starts afresh."""
        out = []
        for m, kind in zip(self.missions, self.kinds):
            mode = ISO_ASCII
            if kind == KIND_ISO_2022_JP:
                mode = int(self.iso_modes(data, np.array([lo]))[0])
            out.extend(_mission_findings(m, data, lo, hi, mode, carry))
        out = [f for f in out if lo <= f.position < hi]
        out.sort(key=lambda f: f.sort_key())
        return out

    def region_lines(self, data: np.ndarray, lo: int, hi: int,
                     carry: bool = True) -> List[bytes]:
        """The output lines (no newline) of `region_findings`."""
        return [f.format(self.args)[1:]
                for f in self.region_findings(data, lo, hi, carry)]


def _mission_findings(m, data, lo, hi, mode, carry):
    prefix = b""
    if mode != ISO_ASCII:
        prefix = _ISO_PREFIX[mode] + bytes(SLICE - 3)
    stream = np.concatenate([np.frombuffer(prefix, np.uint8), data[lo:hi]])
    base = lo - len(prefix)
    found = []
    if carry:
        scanner = SliceScanner(dataclasses.replace(
            m, counter_offset=m.counter_offset + base))
        ev = generate_events(stream, m.encoding_name)
        for s in range(0, len(stream), SLICE):
            found.extend(scanner.scan_slice(stream[s:s + SLICE], s, ev, 1,
                                            False))
        return found
    step = 2 * m.output_line_char_nb_max  # one decode window
    for s in range(0, len(stream), step):
        piece = stream[s:s + step]
        scanner = SliceScanner(dataclasses.replace(
            m, counter_offset=m.counter_offset + base + s))
        ev = generate_events(piece, m.encoding_name)
        found.extend(scanner.scan_slice(piece, 0, ev, 1, False))
    return found
