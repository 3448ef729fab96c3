"""The SWAR kernels of the scan: per-block mission counts and packed
per-byte mission fields.

Counterpart: stringsext_tpu/ops/pallas_swar.py - `swar_counts` :820,
its kernel `_swar_counts_kernel` :783, the mask algebra
`_swar_boundary_masks` :641, `_utf8_structure` :161, `_utf16_*`
:370-461, `_sbyte_masks` :485 and the stream-edge zeroing `_edge_halos`
:546; `flagship_swar_lanes` :590 (kernel `_flagship_swar_kernel` :572)
with the field words `swar_utf8_panel` :334, `swar_utf16_panel` :461
and `swar_sbyte_panel` :501; `swar_params` :938.

`swar_counts` and `flagship_swar_lanes` launch the CUDA kernels
`csrc/swar_counts.cu` and `csrc/swar_lanes.cu` for a CUDA tensor and run
their plain torch versions `swar_counts_ref` and `flagship_swar_lanes_ref`
for a CPU tensor. All read the missions from the same packed table
(`pack_specs`), so the CPU tests also check what the kernels are given.

Contract of `swar_counts` (pallas_swar.py:828-846): `words` is int32
[rows, 128], four little-endian stream bytes per word, one row per
512-byte block. The result is int32 [R, rows], R = 2*len(specs) rounded
up to a multiple of 8: row 2m holds run_start | run_end << 10 | accept
<< 20 of mission m, row 2m+1 its grep count, padding rows are zero.
`hot_only` leaves run_start and run_end zero; `xor_word` is XORed into
every word first. The stream behaves as if surrounded by zero bytes.

Field words (`flagship_swar_lanes`, and the slab re-derivation of
runs.extract_runs_swar_blocks): one 7-bit field per stream byte - accept
bit 0, char length bits 1-3 (at char starts), grep bit 4, start bit 5,
valid start bit 6. UTF-16 fields sit at each unit's first byte, so a
word holds them at bits 0-7 and 16-23; single-byte fields have no valid
bit (pallas_swar.py:505).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .classify import _shift_left, _shift_right
from .runs import _as_int32
from .specs import utf8_lead_intervals, utf16_cp_intervals

LANE = 128  # int32 words per row
BLOCK = 512  # stream bytes per row

# Packed spec table, one record of _REC int32 per mission (read by
# csrc/swar_counts.cu and csrc/swar_lanes.cu - keep the three in step):
# a header of _HDR fields, then interval list A and interval list B,
# _MAX_IV (lo, hi) pairs each, then two 256-bit byte tables of 8 words
# (bit v & 31 of word v >> 5 stands for byte value v) that the kernels
# look bytes up in instead of walking the lists.
#   utf8:  A = AF byte intervals, B = UBF lead-byte intervals;
#          table A = the bytes in A or B
#   utf16: A = codepoint intervals; no tables
#   sbyte: A = accepted bytes, B = grep bytes; table A, table B
_REC, _HDR, _MAX_IV = 88, 8, 16
T_A = _HDR + 4 * _MAX_IV
T_B = T_A + 8
H_KIND, H_BE, H_ASTRAL, H_LENS, H_GREP, H_NA, H_NB = range(7)
KINDS = ("utf8", "utf16", "sbyte")


class SpecRecord(NamedTuple):
    """One mission as the kernel reads it from the packed table."""

    kind: str
    be: bool
    astral: bool  # UTF-16: test the decoded astral codepoint of a pair
    lens: int  # bit L-1: char length class L takes part in run bounds
    grep: int  # grep char (-1: none); sbyte greps through list B
    a: Tuple[Tuple[int, int], ...]
    b: Tuple[Tuple[int, int], ...]


def _iv_hits(iv, lo, hi) -> bool:
    return any(a <= hi and b >= lo for a, b in iv)


def _record(spec) -> SpecRecord:
    """Derive the static flags the reference decides while tracing:
    which length classes can carry an accepted char (pallas_swar.py:
    704-731 prunes the others) and whether UTF-16 needs the decoded
    astral codepoint (:389-404)."""
    kind = spec[0]
    if kind == "utf8":
        _k, af_iv, ubf_iv, grep = spec
        lens = 1 if af_iv else 0
        for L, lo, hi in ((2, 0xC2, 0xDF), (3, 0xE0, 0xEF), (4, 0xF0, 0xF4)):
            if _iv_hits(ubf_iv, lo, hi):
                lens |= 1 << (L - 1)
        return SpecRecord("utf8", False, False, lens, int(grep),
                          tuple(af_iv), tuple(ubf_iv))
    if kind == "utf16":
        _k, be, cp_iv, grep = spec
        astral = any(hi >= 0x10000 or (lo <= 0xDFFF and hi >= 0xD800)
                     for lo, hi in cp_iv)
        lens = 0b0010 | (0b1000 if any(hi >= 0x10000 for _lo, hi in cp_iv)
                         else 0)
        return SpecRecord("utf16", bool(be), astral, lens, int(grep),
                          tuple(cp_iv), ())
    if kind == "sbyte":
        _k, acc_iv, grep_iv = spec
        return SpecRecord("sbyte", False, False, 0b0001, -1,
                          tuple(acc_iv), tuple(grep_iv))
    raise ValueError(f"unknown spec kind {kind!r}")


def byte_table(iv) -> np.ndarray:
    """The byte values within the (lo, hi) intervals `iv` as a 256-bit
    table: 8 int32 words, bit v & 31 of word v >> 5 for value v."""
    hit = np.zeros(256, bool)
    for lo, hi in iv:
        hit[max(lo, 0):min(hi, 255) + 1] = True
    return np.packbits(hit, bitorder="little").view(np.int32)


def pack_specs(specs) -> np.ndarray:
    """Spec tuples of `specs.swar_mission_spec` ->
    int32 [len(specs), _REC], the table the kernel reads."""
    if not specs:
        raise ValueError("swar_counts needs at least one mission spec")
    table = np.zeros((len(specs), _REC), np.int32)
    for i, sp in enumerate(specs):
        r = _record(sp)
        if len(r.a) > _MAX_IV or len(r.b) > _MAX_IV:
            raise ValueError(
                f"spec {i} has more than {_MAX_IV} intervals in one list")
        if any(not 0 <= v < 1 << 30 for iv in r.a + r.b for v in iv):
            # csrc/mission_fields.cuh tests an interval by the signs of
            # cp - lo and hi - cp
            raise ValueError(f"spec {i} has an interval bound outside "
                             f"[0, 2**30)")
        t = table[i]
        t[H_KIND] = KINDS.index(r.kind)
        t[H_BE], t[H_ASTRAL], t[H_LENS], t[H_GREP] = (
            r.be, r.astral, r.lens, r.grep)
        t[H_NA], t[H_NB] = len(r.a), len(r.b)
        for base, iv in ((_HDR, r.a), (_HDR + 2 * _MAX_IV, r.b)):
            for k, (lo, hi) in enumerate(iv):
                t[base + 2 * k], t[base + 2 * k + 1] = lo, hi
        if r.kind == "utf8":
            t[T_A:T_A + 8] = byte_table(r.a + r.b)
        elif r.kind == "sbyte":
            t[T_A:T_A + 8] = byte_table(r.a)
            t[T_B:T_B + 8] = byte_table(r.b)
    return table


def spec_records(table: np.ndarray):
    """The SpecRecords of a packed table (the kernel's view of it)."""
    out = []
    for t in np.asarray(table):
        na, nb = int(t[H_NA]), int(t[H_NB])
        ivs = []
        for base, cnt in ((_HDR, na), (_HDR + 2 * _MAX_IV, nb)):
            ivs.append(tuple((int(t[base + 2 * k]), int(t[base + 2 * k + 1]))
                             for k in range(cnt)))
        out.append(SpecRecord(KINDS[int(t[H_KIND])], bool(t[H_BE]),
                              bool(t[H_ASTRAL]), int(t[H_LENS]),
                              int(t[H_GREP]), ivs[0], ivs[1]))
    return out


def swar_params(missions):
    """Static interval parameters for flagship_swar_lanes, or None when
    a filter decomposes into too many intervals to be worth it (a copy
    of pallas_swar.py:938-952, whose module imports jax)."""
    m8, mle, mbe = missions[0], missions[1], missions[2]
    af_iv, ubf_iv = utf8_lead_intervals(m8)
    cp_le = utf16_cp_intervals(mle)
    cp_be = utf16_cp_intervals(mbe)
    if len(af_iv) + len(ubf_iv) > 12 or len(cp_le) > 12 or len(cp_be) > 12:
        return None
    greps = tuple(
        -1 if m.filter.grep_char is None else int(m.filter.grep_char)
        for m in (m8, mle, mbe)
    )
    return dict(af_iv=af_iv, ubf_iv=ubf_iv, cp_iv_le=cp_le, cp_iv_be=cp_be,
                greps=greps)


def flagship_specs(af_iv, ubf_iv, cp_iv_le, cp_iv_be, greps):
    """The spec tuples of the flagship trio (pallas_swar.py:907-911)."""
    return (("utf8", af_iv, ubf_iv, greps[0]),
            ("utf16", False, cp_iv_le, greps[1]),
            ("utf16", True, cp_iv_be, greps[2]))


def out_rows(nspecs: int) -> int:
    return ((2 * nspecs + 7) // 8) * 8


def _check_budget(table: np.ndarray, hot_only: bool) -> None:
    """The reference fuses a full-mode mission set only within 8
    length-class bits (pallas_swar.py:758); the port keeps that limit
    so both accept the same mission sets."""
    if not hot_only:
        nbit = sum(bin(int(x)).count("1") for x in table[:, H_LENS])
        if nbit > 8:
            raise ValueError(
                "mission set exceeds the 8-bit length-class budget")


def _check_words(words: torch.Tensor) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError("words must be a torch.Tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != LANE:
        raise ValueError(f"words must be [rows, {LANE}], got "
                         f"{tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


def _xor_value(xor_word) -> int:
    """xor_word (int or one-element tensor) as a signed int32 value."""
    if isinstance(xor_word, torch.Tensor):
        xor_word = xor_word.reshape(-1)[0]
    return _as_int32(xor_word)


# ------------------------------------------------------------ plain torch
#
# Every per-byte function below works along the last dimension, so the
# same code serves the whole stream [n] and the run compaction's
# independent slabs [K, m]. Positions outside the last dimension are
# zero bytes.


def _in_intervals(v: torch.Tensor, iv) -> torch.Tensor:
    hit = torch.zeros_like(v, dtype=torch.bool)
    for lo, hi in iv:
        hit |= (v >= lo) & (v <= hi)
    return hit


def _utf8_structure(b: torch.Tensor):
    """(is_start, ev_valid, [s1, s2, s3, s4]) per byte: the
    filter-independent UTF-8 masks (pallas_swar.py::_utf8_structure;
    sL = starts a char whose length class is L)."""
    cont = (b & 0xC0) == 0x80
    c1, c2, c3 = (_shift_left(cont, k, 0) for k in (1, 2, 3))
    b1 = _shift_left(b, 1, 0)
    lead1 = b < 0x80
    lead2 = (b >= 0xC2) & (b <= 0xDF)
    lead3 = (b >= 0xE0) & (b <= 0xEF)
    lead4 = (b >= 0xF0) & (b <= 0xF4)
    c1ok3 = c1 & ~(((b == 0xE0) & (b1 < 0xA0)) | ((b == 0xED) & (b1 > 0x9F)))
    c1ok4 = c1 & ~(((b == 0xF0) & (b1 < 0x90)) | ((b == 0xF4) & (b1 > 0x8F)))
    valid2 = lead2 & c1
    valid3 = lead3 & c1ok3 & c2
    valid4 = lead4 & c1ok4 & c2 & c3
    ev_valid = lead1 | valid2 | valid3 | valid4
    bad2 = ((lead3 & c1ok3) | (lead4 & c1ok4)) & ~c2
    bad3 = lead4 & c1ok4 & c2 & ~c3
    ge2 = valid2 | valid3 | valid4 | bad2 | bad3
    ge3 = valid3 | valid4 | bad3
    noncont = ~cont
    claimed = (_shift_right(noncont & ge2, 1, 0)
               | _shift_right(noncont & ge3, 2, 0)
               | _shift_right(noncont & valid4, 3, 0))
    is_start = ~(cont & claimed)
    s2 = is_start & (valid2 | bad2)
    s3 = is_start & (valid3 | bad3)
    s4 = is_start & valid4
    s1 = is_start & ~(s2 | s3 | s4)
    return is_start, ev_valid, [s1, s2, s3, s4]


def _run_bounds(acc, classes):
    """(run_start, run_end) masks from the accept mask and the
    (shift, starts-of-class) pairs of the classes taking part: an
    accepted char continues a run when an accepted char of length L
    ends right before it, and joins the next one when the char L
    positions ahead is accepted (pallas_swar.py:740-780)."""
    cont = torch.zeros_like(acc)
    joins = torch.zeros_like(acc)
    for shift, sl in classes:
        cont |= _shift_right(acc & sl, shift, 0)
        joins |= sl & _shift_left(acc, shift, 0)
    return acc & ~cont, acc & ~joins


def _grep_mask(acc, v, grep: int):
    return acc & (v == grep) if grep >= 0 else torch.zeros_like(acc)


def _utf8_masks(b, r: SpecRecord, u8):
    """(acc, grep) per byte of a UTF-8 mission, given the shared
    `_utf8_structure(b)`."""
    is_start, ev_valid, _sl = u8
    acc = is_start & ev_valid & (_in_intervals(b, r.a) | _in_intervals(b, r.b))
    return acc, _grep_mask(acc, b, r.grep)


def _sbyte_masks(b, r: SpecRecord):
    """(acc, grep) per byte of a single-byte mission."""
    acc = _in_intervals(b, r.a)
    return acc, acc & _in_intervals(b, r.b)


def _utf16_units(b: torch.Tensor, r: SpecRecord):
    """(acc, grep, start, valid, pair) per code unit of the byte stream
    `b` (even length, unit k = bytes 2k, 2k+1)."""
    lo8, hi8 = (b[..., 1::2], b[..., 0::2]) if r.be else (b[..., 0::2],
                                                          b[..., 1::2])
    u = lo8 | (hi8 << 8)
    high = (u >> 10) == 0x36
    low = (u >> 10) == 0x37
    pair = high & _shift_left(low, 1, 0)
    trail = _shift_right(pair, 1, 0)
    valid = ((~high & ~low) | pair) & ~trail
    start = ~trail
    if r.astral:
        nxt = _shift_left(u, 1, 0)
        astral = 0x10000 + ((u & 0x3FF) << 10) + (nxt & 0x3FF)
        cp = torch.where(pair, astral, u)
    else:
        cp = u
    acc = valid & _in_intervals(cp, r.a)
    return acc, _grep_mask(acc, cp, r.grep), start, valid, pair


def _utf16_masks(b: torch.Tensor, r: SpecRecord, hot_only: bool):
    """(acc, grep, run_start, run_end) per code unit."""
    acc, grep, start, _valid, pair = _utf16_units(b, r)
    if hot_only:
        z = torch.zeros_like(acc)
        return acc, grep, z, z
    classes = [(1, start & ~pair)]
    if r.lens & 0b1000:
        classes.append((2, start & pair))
    rs, re = _run_bounds(acc, classes)
    return acc, grep, rs, re


def byte_fields(b: torch.Tensor, r: SpecRecord, u8=None) -> torch.Tensor:
    """int32 7-bit mission field per byte of `b` (int32 byte values; see
    the module docstring), the per-byte form of swar_utf8_panel,
    swar_utf16_panel and swar_sbyte_panel. UTF-16 fields stand at even
    positions (the last dimension must be even), odd positions are 0.
    `u8` may pass a `_utf8_structure(b)` shared between UTF-8 missions."""
    if r.kind == "utf16":
        acc, grep, start, valid, pair = _utf16_units(b, r)
        ln = torch.where(start, torch.where(pair, 4, 2), 0).int()
        f = (acc.int() | (ln << 1) | (grep.int() << 4) | (start.int() << 5)
             | ((start & valid).int() << 6))
        return torch.stack([f, torch.zeros_like(f)], -1).flatten(-2)
    if r.kind == "sbyte":
        acc, grep = _sbyte_masks(b, r)
        return acc.int() | (1 << 1) | (grep.int() << 4) | (1 << 5)
    u8 = _utf8_structure(b) if u8 is None else u8
    is_start, ev_valid, sl = u8
    acc, grep = _utf8_masks(b, r, u8)
    ln = sl[0].int() + 2 * sl[1].int() + 3 * sl[2].int() + 4 * sl[3].int()
    return (acc.int() | (ln << 1) | (grep.int() << 4) | (is_start.int() << 5)
            | ((is_start & ev_valid).int() << 6))


def _stream_bytes(words: torch.Tensor, xor_word=None) -> torch.Tensor:
    """The stream bytes of int32 `words` as int32 values with 8 zero
    bytes of context on each side (the longest dependency is 7)."""
    w = words if xor_word is None else words ^ _xor_value(xor_word)
    raw = w.reshape(-1).view(torch.uint8).to(torch.int32)
    pad = raw.new_zeros(8)
    return torch.cat([pad, raw, pad])


def swar_counts_ref(words: torch.Tensor, specs, hot_only: bool = False,
                    xor_word=None) -> torch.Tensor:
    """Plain torch version of `swar_counts` on any device: per-byte
    boolean masks over the whole stream, per-block sums."""
    _check_words(words)
    table = pack_specs(specs)
    _check_budget(table, hot_only)
    rows = words.shape[0]
    n = rows * BLOCK
    b = _stream_bytes(words, xor_word)
    out = torch.zeros((out_rows(len(specs)), rows), dtype=torch.int32,
                      device=words.device)
    u8 = None
    for m, r in enumerate(spec_records(table)):
        if r.kind == "utf16":
            acc, grep, rs, re = _utf16_masks(b, r, hot_only)
            own, per = slice(4, 4 + n // 2), BLOCK // 2
        else:
            if r.kind == "utf8":
                if u8 is None:
                    u8 = _utf8_structure(b)
                acc, grep = _utf8_masks(b, r, u8)
                classes = [(L, u8[2][L - 1]) for L in (1, 2, 3, 4)
                           if (r.lens >> (L - 1)) & 1]
            else:
                acc, grep = _sbyte_masks(b, r)
                classes = [(1, torch.ones_like(acc))]
            if hot_only:
                rs = re = torch.zeros_like(acc)
            else:
                rs, re = _run_bounds(acc, classes)
            own, per = slice(8, 8 + n), BLOCK

        def blocks(x):
            return x[own].reshape(rows, per).sum(1, dtype=torch.int32)

        out[2 * m] = blocks(rs) | (blocks(re) << 10) | (blocks(acc) << 20)
        out[2 * m + 1] = blocks(grep)
    return out


def flagship_swar_lanes_ref(words_2d: torch.Tensor, af_iv, ubf_iv,
                            cp_iv_le, cp_iv_be, greps):
    """Plain torch version of `flagship_swar_lanes` on any device:
    per-byte fields over the zero-surrounded stream, packed 4 per word
    (fields stay below 0x80, so the int32 packing cannot overflow)."""
    _check_words(words_2d)
    table = pack_specs(flagship_specs(af_iv, ubf_iv, cp_iv_le, cp_iv_be,
                                      greps))
    n = words_2d.numel() * 4
    b = _stream_bytes(words_2d)
    u8 = None
    out = []
    for r in spec_records(table):
        if r.kind == "utf8" and u8 is None:
            u8 = _utf8_structure(b)
        f = byte_fields(b, r, u8)[8:8 + n].reshape(-1, 4)
        out.append((f[:, 0] | (f[:, 1] << 8) | (f[:, 2] << 16)
                    | (f[:, 3] << 24)).reshape(words_2d.shape))
    return tuple(out)


# ------------------------------------------------------------ CUDA kernels


def _freeze(x):
    """`x` with its lists made tuples, so that it can key a cache; specs
    that are tuples all the way down (`swar_params`'s) come back as they
    are, for the price of a hash."""
    try:
        hash(x)
        return x
    except TypeError:
        return tuple(_freeze(v) for v in x)


@functools.lru_cache(maxsize=64)
def _device_table(specs, device):
    """(pack_specs(specs), the same table on `device`), kept between
    launches: packing walks the interval lists in Python, and the copy to
    the card is a transfer a launch. `specs` must be hashable (`_freeze`)."""
    table = pack_specs(specs)
    return table, torch.from_numpy(table).to(device)


_lib_fn = None


def _launcher():
    global _lib_fn
    if _lib_fn is None:
        from .. import _build

        lib = _build.load_library()
        fn = lib.swar_counts_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_int64,  # rows
            ctypes.c_void_p,  # out
            ctypes.c_int,  # out_rows
            ctypes.c_void_p,  # table
            ctypes.c_int,  # nspecs
            ctypes.c_int,  # hot_only
            ctypes.c_int,  # kinds: bit 0 a utf8 record, bit 1 a utf16 one
            ctypes.c_uint32,  # xor_word
            ctypes.c_int,  # device index
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.swar_error_string.restype = ctypes.c_char_p
        lib.swar_error_string.argtypes = [ctypes.c_int]
        _lib_fn = (fn, lib.swar_error_string)
    return _lib_fn


def swar_counts(words: torch.Tensor, specs, hot_only: bool = False,
                xor_word=None) -> torch.Tensor:
    """Per-block mission counts (see the module docstring). A CUDA tensor
    goes to the kernel `csrc/swar_counts.cu` on the current stream, and
    a failed build or launch raises; a CPU tensor goes to
    `swar_counts_ref`. `swar_counts.launches` counts kernel launches."""
    _check_words(words)
    if words.device.type == "cpu":
        return swar_counts_ref(words, specs, hot_only, xor_word)
    if words.device.type != "cuda":
        raise ValueError(f"swar_counts runs on cuda or cpu, not "
                         f"{words.device}")
    table, tab = _device_table(_freeze(specs), words.device)
    _check_budget(table, hot_only)
    rows = words.shape[0]
    out = torch.empty((out_rows(len(specs)), rows), dtype=torch.int32,
                      device=words.device)
    if rows == 0:
        return out
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    xw = 0 if xor_word is None else _xor_value(xor_word) & 0xFFFFFFFF
    fn, err_str = _launcher()
    stream = torch.cuda.current_stream(words.device)
    kinds = sum(1 << k for k in (0, 1) if (table[:, H_KIND] == k).any())
    err = fn(words.data_ptr(), rows, out.data_ptr(), out.shape[0],
             tab.data_ptr(), len(specs), int(bool(hot_only)), kinds, xw,
             words.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"swar_counts kernel launch failed: {err_str(err).decode()}")
    swar_counts.launches += 1
    return out


swar_counts.launches = 0


_SWAR_LANES_ARGS = [
    ctypes.c_void_p,  # words
    ctypes.c_int64,  # rows
    ctypes.c_void_p,  # out [3][rows][128]
    ctypes.c_void_p,  # table: the trio's three records
    ctypes.c_int,  # whether a record holds a grep char
    ctypes.c_int,  # device index
    ctypes.c_void_p,  # cudaStream_t
]


def flagship_swar_lanes(words_2d: torch.Tensor, af_iv, ubf_iv, cp_iv_le,
                        cp_iv_be, greps):
    """Field words of the flagship trio in one pass: (utf8, utf16le,
    utf16be), each int32 shaped like `words_2d` (pallas_swar.py:590; the
    interval arguments are `swar_params`'s). A CUDA tensor goes to the
    kernel `csrc/swar_lanes.cu` on the current stream, and a failed build
    or launch raises; a CPU tensor goes to `flagship_swar_lanes_ref`.
    `flagship_swar_lanes.launches` counts kernel launches."""
    _check_words(words_2d)
    if words_2d.device.type == "cpu":
        return flagship_swar_lanes_ref(words_2d, af_iv, ubf_iv, cp_iv_le,
                                       cp_iv_be, greps)
    if words_2d.device.type != "cuda":
        raise ValueError(f"flagship_swar_lanes runs on cuda or cpu, not "
                         f"{words_2d.device}")
    specs = flagship_specs(af_iv, ubf_iv, cp_iv_le, cp_iv_be, greps)
    _table, tab = _device_table(_freeze(specs), words_2d.device)
    out = torch.empty((len(specs),) + tuple(words_2d.shape),
                      dtype=torch.int32, device=words_2d.device)
    if words_2d.numel() == 0:
        return out.unbind(0)
    if words_2d.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    from .. import _build

    stream = torch.cuda.current_stream(words_2d.device)
    _build.launch("swar_lanes_launch", _SWAR_LANES_ARGS,
                  words_2d.data_ptr(), words_2d.shape[0], out.data_ptr(),
                  tab.data_ptr(), int(any(g >= 0 for g in greps)),
                  words_2d.device.index, stream.cuda_stream)
    flagship_swar_lanes.launches += 1
    return out.unbind(0)


flagship_swar_lanes.launches = 0
