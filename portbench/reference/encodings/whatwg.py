"""Vendored WHATWG Encoding Standard index tables (runtime loader).

The reference delegates decoding to the encoding_rs crate, which
implements the WHATWG indexes (reference/src/mission.rs:681,
src/scanner.rs:76, src/finding_collection.rs:139). This module is the
single source of truth those decoders' analogs (the python oracle in
engine/, the native C++ emitter, and the device kernels in ops/) load
their tables from.

The data file `whatwg_data.npz` is generated OFFLINE by
scripts/gen_whatwg_tables.py from multiple independent sources (Python
codecs, glibc iconv, structural identities of the indexes) with every
divergence hand-audited in `whatwg_audit.json`; it is checked in, and
tests/test_whatwg_tables.py pins both the table contents and the
audited divergence sets. Nothing here calls Python's codecs at
runtime.

Canonical index layouts (WHATWG "indexes" section):
- single-byte:  128 entries, index = byte - 0x80, value = codepoint
                or -1 (decode error).
- jis0208:      11280 entries, Shift_JIS pointer order; shared by
                Shift_JIS, EUC-JP and ISO-2022-JP. Pointers
                8836..10715 are null in the index; the Shift_JIS
                decoder maps them to U+E000 + pointer - 8836 (EUDC).
- jis0212:      94*94 entries (EUC-JP 0x8F three-byte forms).
- euc-kr:       (lead-0x81)*190 + (trail-0x41).
- big5:         (lead-0x81)*157 + (trail-0x40|0x62); four pointers
                decode to TWO codepoints (`big5_multi`).
- gb18030:      (lead-0x81)*190 + (trail-0x40|0x41), total (no nulls).
- gb18030-ranges: (pointer, codepoint) breakpoints for 4-byte forms,
                incl. the pointer-7457 -> U+E7C7 special case as its
                own breakpoint pair.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "whatwg_data.npz")


@functools.lru_cache(maxsize=None)
def _data():
    # Every table is read here, once: the missions' threads reach the
    # tables together, and CPython 3.12 releases whose zipfile seeks
    # relative to the shared file's position (not the member's) corrupt
    # members read lazily from one archive by several threads at once.
    with np.load(_DATA_PATH) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def single_byte(name: str) -> np.ndarray:
    """128-entry int32 index for a single-byte encoding (read-only)."""
    t = _data()[f"sb_{name}"].astype(np.int32)
    t.setflags(write=False)
    return t


@functools.lru_cache(maxsize=None)
def jis0208() -> np.ndarray:
    t = _data()["jis0208"].astype(np.int32)
    t.setflags(write=False)
    return t


@functools.lru_cache(maxsize=None)
def pair_cp(kind: str) -> np.ndarray:
    """int32[256,256]: codepoint for a (lead, trail) two-byte sequence,
    -1 where the pair is not a valid two-byte character. Big5's four
    double-codepoint pointers are -1 here; see `pair_multi`.

    Kinds: 'shift_jis' (incl. the EUDC formula area), 'euc-jp' (the
    A1-FE jis0208 plane), 'euc-kr', 'big5', 'gb18030' (GBK decodes with
    the same table, WHATWG 11)."""
    d = _data()
    out = np.full((256, 256), -1, dtype=np.int32)
    if kind == "shift_jis":
        idx = jis0208()
        leads = np.array(
            list(range(0x81, 0xA0)) + list(range(0xE0, 0xFD)), np.int32)
        trails = np.array(
            [t for t in range(0x40, 0xFD) if t != 0x7F], np.int32)
        li = np.where(leads < 0xA0, leads - 0x81, leads - 0xC1)
        ti = np.where(trails < 0x7F, trails - 0x40, trails - 0x41)
        p = li[:, None] * 188 + ti[None, :]
        v = idx[p]
        eudc = (p >= 8836) & (p <= 10715)
        v = np.where(eudc, 0xE000 + p - 8836, v)
        out[np.ix_(leads, trails)] = v
    elif kind == "euc-jp":
        idx = jis0208()
        lt = np.arange(0xA1, 0xFF, dtype=np.int32)
        p = (lt[:, None] - 0xA1) * 94 + (lt[None, :] - 0xA1)
        out[np.ix_(lt, lt)] = idx[p]
    elif kind == "euc-kr":
        idx = d["euc_kr"]
        leads = np.arange(0x81, 0xFF, dtype=np.int32)
        trails = np.arange(0x41, 0xFF, dtype=np.int32)
        p = (leads[:, None] - 0x81) * 190 + (trails[None, :] - 0x41)
        out[np.ix_(leads, trails)] = idx[p]
    elif kind == "big5":
        idx = d["big5"]
        leads = np.arange(0x81, 0xFF, dtype=np.int32)
        trails = np.array(
            list(range(0x40, 0x7F)) + list(range(0xA1, 0xFF)), np.int32)
        off = np.where(trails < 0x7F, 0x40, 0x62)
        p = (leads[:, None] - 0x81) * 157 + (trails - off)[None, :]
        out[np.ix_(leads, trails)] = idx[p]
    elif kind == "gb18030":
        idx = d["gb18030"]
        leads = np.arange(0x81, 0xFF, dtype=np.int32)
        trails = np.array(
            [t for t in range(0x40, 0xFF) if t != 0x7F], np.int32)
        off = np.where(trails < 0x7F, 0x40, 0x41)
        p = (leads[:, None] - 0x81) * 190 + (trails - off)[None, :]
        out[np.ix_(leads, trails)] = idx[p]
    else:
        raise KeyError(f"no pair table for kind: {kind}")
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def pair_multi(kind: str) -> Dict[int, Tuple[int, ...]]:
    """lead*256+trail -> codepoints, for pairs decoding to more than
    one codepoint (WHATWG big5: pointers 1133/1135/1164/1166)."""
    if kind != "big5":
        return {}
    out: Dict[int, Tuple[int, ...]] = {}
    for p, c1, c2 in _data()["big5_multi"].tolist():
        lead = 0x81 + p // 157
        r = p % 157
        trail = r + 0x40 if r < 0x3F else r + 0x62
        out[lead * 256 + trail] = (int(c1), int(c2))
    return out


@functools.lru_cache(maxsize=None)
def jis0212_cp() -> np.ndarray:
    """int32[256,256]: [b2, b3] -> codepoint for EUC-JP 0x8F forms."""
    idx = _data()["jis0212"]
    out = np.full((256, 256), -1, dtype=np.int32)
    lt = np.arange(0xA1, 0xFF, dtype=np.int32)
    p = (lt[:, None] - 0xA1) * 94 + (lt[None, :] - 0xA1)
    out[np.ix_(lt, lt)] = idx[p]
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def gb18030_ranges() -> Tuple[np.ndarray, np.ndarray]:
    """(pointers int64[N], codepoints int32[N]) breakpoints; decode of
    4-byte pointer p: i = rightmost breakpoint <= p,
    cp = codepoints[i] + (p - pointers[i])."""
    d = _data()
    p = d["gb18030_ranges_ptr"].astype(np.int64)
    c = d["gb18030_ranges_cp"].astype(np.int32)
    p.setflags(write=False)
    c.setflags(write=False)
    return p, c


def gb18030_range_decode(pointer: int) -> int:
    ptrs, cps = gb18030_ranges()
    i = int(np.searchsorted(ptrs, pointer, side="right")) - 1
    return int(cps[i]) + pointer - int(ptrs[i])
