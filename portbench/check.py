"""The comparison that decides `correct`.

A scan's whole output stream is read for its frame (the BOM first, one
newline last), its line grammar (precision tag, hex offset, continuation
tag, tab, the mission's letter and encoding, tab, a non-empty string) and
its order (offset, then mission). Then regions of the image, drawn from
the seed, are scanned by the plain reference (`reference/regions.py`)
and the lines whose offsets lie in each region must equal the
reference's, byte for byte. Regions always include the image's head and
tail and a seed-drawn choice among the seams where the port cuts its
work (the streamed path's chunks, the buffered hot map's passes), among
the planted strings (where the traffic asks, some in every chunk), and
among uniform offsets.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .reference.regions import Reference

BOM = b"\xef\xbb\xbf"

_HEX = np.full(256, -1, np.int64)
_HEX[np.frombuffer(b"0123456789abcdef", np.uint8)] = np.arange(16)
_MAX_HEX = 16


class Parsed:
    """Line starts, offsets and mission letters of one output stream,
    with the counts of frame, grammar and order faults."""

    def __init__(self, out: bytes, ref: Reference):
        self.out = out
        self.frame_errors = int(not out.startswith(BOM)) + int(
            not out.endswith(b"\n"))
        buf = np.frombuffer(out, np.uint8)
        nl = np.flatnonzero(buf == 0x0A)
        # "\n" + line for every finding, then the closing "\n".
        self.starts = nl[:-1] + 1
        self.ends = nl[1:]
        ok = (len(nl) == 0 or nl[0] == len(BOM)) and len(nl) > 0
        self.frame_errors += int(not ok)
        self.position, self.letter, self.grammar_errors = _grammar(
            buf, self.starts, self.ends, ref)
        key_pos = self.position[:-1] > self.position[1:]
        same = self.position[:-1] == self.position[1:]
        key_mis = same & (self.letter[:-1] > self.letter[1:])
        self.order_errors = int(np.count_nonzero(key_pos | key_mis))

    def lines_in(self, lo: int, hi: int) -> List[bytes]:
        sel = np.flatnonzero((self.position >= lo) & (self.position < hi))
        return [self.out[int(self.starts[k]):int(self.ends[k])] for k in sel]


def _grammar(buf, starts, ends, ref: Reference):
    """(offset, letter, number of malformed lines): `[ <>]HEX[ +]\\t`,
    then `(L ENCODING)\\t` of a mission, then at least one byte."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    pad = np.concatenate([buf, np.zeros(_MAX_HEX + 64, np.uint8)])
    bad = ~np.isin(pad[starts], np.frombuffer(b" <>", np.uint8))
    cols = starts[:, None] + 1 + np.arange(_MAX_HEX + 1)
    digits = _HEX[pad[cols]]
    width = np.argmin(digits >= 0, axis=1)
    bad |= width == 0
    value = np.zeros(n, np.uint64)
    for i in range(_MAX_HEX):
        live = i < width
        value = np.where(live, value * np.uint64(16)
                         + digits[:, i].clip(0).astype(np.uint64), value)
    tag = starts + 1 + width
    bad |= ~np.isin(pad[tag], np.frombuffer(b" +", np.uint8))
    bad |= pad[tag + 1] != 0x09
    letter = pad[tag + 3].astype(np.int64)
    prefixes = [b"(" + bytes([97 + m.mission_id]) + b" "
                + m.display_encoding_name.encode() + b")\t"
                for m in ref.missions]
    body = np.zeros(n, np.int64)
    known = np.zeros(n, bool)
    for k, p in enumerate(prefixes):
        rows = np.flatnonzero(letter == 97 + k)
        got = pad[tag[rows, None] + 2 + np.arange(len(p))]
        match = (got == np.frombuffer(p, np.uint8)).all(axis=1)
        known[rows[match]] = True
        body[rows] = tag[rows] + 2 + len(p)
    bad |= ~known
    bad |= body >= ends
    return value.astype(np.int64), letter, int(np.count_nonzero(bad))


def sample_regions(ref: Reference, image: np.ndarray, marks: np.ndarray,
                   seams: Sequence[int], plan: Dict[str, int],
                   rng: np.random.Generator) -> List[Tuple[int, int]]:
    """(lo, hi) calm-boundary pairs: the head, the tail, and up to
    plan["seams"], plan["marks"] and plan["random"] regions around
    seed-drawn seams, planted strings and uniform offsets, then up to
    plan["marks_each_seam"] (if given) around planted strings drawn
    between each two seams, so that every chunk of the port's work is
    compared; each at least plan["bytes"] long, merged where they
    overlap."""
    n = len(image)
    calm = ref.calm_boundaries(image)
    size = int(plan["bytes"])
    centres = []
    for key, pool in (("seams", np.asarray(seams, np.int64)),
                      ("marks", marks)):
        pool = pool[(pool > 0) & (pool < n)]
        take = min(len(pool), int(plan[key]))
        centres.extend(rng.choice(pool, take, replace=False).tolist())
    centres.extend(rng.integers(0, n, int(plan["random"])).tolist())
    each = int(plan.get("marks_each_seam", 0))
    if each:
        cuts = np.concatenate([[0], np.sort(np.asarray(seams, np.int64)),
                               [n]])
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            pool = marks[(marks > 0) & (marks >= lo) & (marks < hi)]
            take = min(len(pool), each)
            centres.extend(rng.choice(pool, take, replace=False).tolist())
    spans = [(0, size), (n - size, n)]
    spans += [(c - size // 2, c + size // 2) for c in centres]
    regions = []
    for a, b in spans:
        i = np.searchsorted(calm, max(a, 0), side="right") - 1
        j = np.searchsorted(calm, min(b, n), side="left")
        regions.append((int(calm[max(i, 0)]), int(calm[min(j, len(calm) - 1)])))
    regions.sort()
    merged = []
    for lo, hi in regions:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def region_mismatches(parsed: Parsed, ref: Reference, image: np.ndarray,
                      regions, carry: bool = True) -> Tuple[int, int]:
    """(lines that differ from the reference's, lines compared) over the
    regions: a region's count is the size of the symmetric difference
    of its two line multisets, or 1 where only the order differs."""
    bad = total = 0
    for lo, hi in regions:
        want = ref.region_lines(image, lo, hi, carry=carry)
        got = parsed.lines_in(lo, hi)
        total += len(want)
        if got != want:
            diff = _multiset_diff(got, want)
            bad += diff if diff else 1
    return bad, total


def _multiset_diff(a: List[bytes], b: List[bytes]) -> int:
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())
