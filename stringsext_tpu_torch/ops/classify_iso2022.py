"""Classification lanes for modal ISO-2022-JP (WHATWG 12.2) as torch ops.

Counterpart: stringsext_tpu/ops/classify_iso2022.py - `_scan_last_set`
:71 (`_scan_last_sets` scans two lanes as it scans one; `_shift_right`
:65 is `classify._shift_right`), `_iso_escapes` :79, `iso_state_transfer` :112,
`iso_pre_lanes` :141, `iso2022_lanes` :246 and the numpy
`iso2022_state_hot_np` :274 (copied verbatim; a test pins it). Each
equals its counterpart element for element, int32 lanes included.

Escape recognition is local (every 0x1B starts an escape attempt); the
mode at every byte and the redundant-escape flag are prefix compositions
of {identity, set} transfers. The reference composes them with
`jax.lax.associative_scan`; here "the last non-negative value at or
before i" is `_scan_last_sets`, which scans both lanes in one launch of
the hand kernel `csrc/last_set_scan.cu` for a CUDA tensor, and takes its
plain twin `_scan_last_set_ref` (a `torch.cummax` over the positions that
hold a value, then a gather) for a CPU tensor. The true event chain (pair
parity in LEAD mode does not resynchronise) is the orbit of the start
under i -> i + step[i], as for the CJK kinds (`classify_cjk._orbit_mask`).

`state_hot` marks every byte whose class depends on the mode or the pair
phase (escape spans and all LEAD-mode data): a hot map built from the
feed keeps these hot, so the emitter's cold-window skipper, which needs
skipped bytes to be mode- and phase-neutral 1-byte events, stays sound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..encodings import KIND_EUC_JP
from ..utils import profiling
from .classify import Lanes, _shift_left, _shift_right
from .classify_cjk import _orbit_mask, _pair_cp_np, _table


_SCAN_TILE = 4096  # positions a thread block of csrc/last_set_scan.cu
_SCAN_ARGS = [
    ctypes.c_void_p,  # t0: int32[n]
    ctypes.c_void_p,  # t1: int32[n]
    ctypes.c_int64,  # n
    ctypes.c_void_p,  # scratch: int64[1 + 2 * ceil(n / 4096)]
    ctypes.c_void_p,  # o0: int32[n]
    ctypes.c_void_p,  # o1: int32[n]
    ctypes.c_int,  # device index
    ctypes.c_void_p,  # cudaStream_t
]


def _scan_last_set_ref(tval: torch.Tensor) -> torch.Tensor:
    """Plain torch version of one lane of `_scan_last_sets` (a
    `torch.cummax` over the positions that hold a value, then a gather),
    on any device: the CPU's lanes, the card's comparison."""
    if tval.numel() == 0:
        return tval
    idx = torch.arange(tval.shape[0], dtype=torch.int64, device=tval.device)
    last = torch.cummax(torch.where(tval >= 0, idx, -1), dim=0).values
    return torch.where(last >= 0, tval[torch.clamp(last, min=0)], -1).to(
        tval.dtype)


def _scan_last_sets(t0: torch.Tensor, t1: torch.Tensor) -> tuple:
    """Inclusive prefix composition of {identity=-1, const=v>=0} of each
    of two lanes: out[i] = last non-negative t[j] with j <= i, else -1.
    The lanes are 1-D contiguous int32 of one length on one device; empty
    lanes come back as they are. The kernel `csrc/last_set_scan.cu` scans
    both in one launch for CUDA tensors (counted in
    `_scan_last_sets.launches` and in the profiling counter
    `iso.scan.kernel`), `_scan_last_set_ref` each for CPU tensors."""
    n = t0.shape[0] if t0.dim() == 1 else -1
    for x in (t0, t1):
        if x.dim() != 1 or x.shape[0] != n or x.dtype != torch.int32:
            raise ValueError("the last-set scan takes two 1-D int32 lanes "
                             "of one length")
        if x.device != t0.device or not x.is_contiguous():
            raise ValueError("the last-set scan's lanes must be contiguous "
                             "and on one device")
    if n == 0:
        return t0, t1
    if n >= 2 ** 31:
        raise ValueError(f"last-set scan: n {n} out of range")
    dev = t0.device
    if dev.type == "cpu":
        return _scan_last_set_ref(t0), _scan_last_set_ref(t1)
    if dev.type != "cuda":
        raise ValueError(f"_scan_last_sets runs on cuda or cpu, not {dev}")
    o0 = torch.empty(n, dtype=torch.int32, device=dev)
    o1 = torch.empty(n, dtype=torch.int32, device=dev)
    # the look-back's ticket and one status word a tile a lane (zeroed by
    # the launcher on the stream)
    scratch = torch.empty(1 + 2 * -(-n // _SCAN_TILE), dtype=torch.int64,
                          device=dev)
    from .. import _build

    stream = torch.cuda.current_stream(dev)
    _build.launch("last_set_scan_launch", _SCAN_ARGS, t0.data_ptr(),
                  t1.data_ptr(), n, scratch.data_ptr(), o0.data_ptr(),
                  o1.data_ptr(), dev.index, stream.cuda_stream)
    _scan_last_sets.launches += 1
    profiling.count("iso.scan.kernel")
    return o0, o1


_scan_last_sets.launches = 0


def _iso_escapes(b, n):
    """Local escape recognition over a chunk (shared by the core and
    the shard state-transfer). Returns a dict of per-byte masks."""
    cap = b.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=b.device)
    in_n = idx < n
    have1 = idx < n - 1
    have2 = idx < n - 2
    b1 = _shift_left(b, 1, 0)
    b2 = _shift_left(b, 2, 0)

    esc = (b == 0x1B) & in_n
    e1_28 = b1 == 0x28
    e1_24 = b1 == 0x24
    set28 = (b2 == 0x42) | (b2 == 0x4A) | (b2 == 0x49)
    set24 = (b2 == 0x40) | (b2 == 0x42)
    valid_esc = esc & have2 & ((e1_28 & set28) | (e1_24 & set24))
    esc_mode = torch.where(b2 == 0x4A, 1, torch.where(b2 == 0x49, 2, 0))
    esc_mode = torch.where(e1_24, 3, esc_mode).to(torch.int32)
    trunc_esc = esc & (~have1 | ((e1_28 | e1_24) & have1 & ~have2))
    invalid_esc = esc & ~valid_esc & ~trunc_esc
    esc_body = (valid_esc | _shift_right(valid_esc, 1, False)
                | _shift_right(valid_esc, 2, False))
    trunc_span = trunc_esc | _shift_right(trunc_esc, 1, False)
    data = in_n & ~esc_body & ~invalid_esc & ~trunc_span
    return dict(
        esc=esc, e1_28=e1_28, e1_24=e1_24, valid_esc=valid_esc,
        esc_mode=esc_mode, trunc_esc=trunc_esc, invalid_esc=invalid_esc,
        esc_body=esc_body, trunc_span=trunc_span, data=data,
        b1=b1, in_n=in_n, have1=have1, have2=have2, idx=idx,
    )


def _int32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _mode_transfers(E) -> torch.Tensor:
    """int32 lane: the mode a valid escape at i-3 sets from i on, else
    -1 (a valid escape takes effect three bytes after its ESC)."""
    neg = torch.full_like(E["esc_mode"], -1)
    return _shift_right(torch.where(E["valid_esc"], E["esc_mode"], neg), 3,
                        -1)


def _flag_transfers(E) -> torch.Tensor:
    """int32 lane of the redundant-escape flag events: a consumed data
    byte clears (0), a valid escape's end sets (1), else -1."""
    fv = _int32(torch.where(E["data"], 0, -1))
    return _int32(torch.where(_shift_right(E["valid_esc"], 2, False), 1, fv))


def iso_state_transfer(b: torch.Tensor, n, lo: int, hi: int) -> torch.Tensor:
    """int32[2] = (mode_t, flag_t): the span's transfer values over
    EFFECT positions in [lo, hi) - the mode set by the last valid escape
    whose effect (ESC+3) lands in the span, and the last redundant-escape
    flag event (valid-escape end sets 1, a consumed data byte clears to
    0); -1 = identity. Effect positions partition the stream across
    spans, so composing these left to right from (mode 0, flag unset)
    gives every span's entry state."""
    b = b.to(torch.int32)
    n = int(n)
    E = _iso_escapes(b, n)
    idx = E["idx"]
    own = (idx >= lo) & (idx < hi)

    def last_val(v):
        v = torch.where(own, v, -1)
        if v.numel() == 0:
            return v.new_full((), -1)
        li = torch.max(torch.where(v >= 0, idx, -1))
        return torch.where(li >= 0, v[torch.clamp(li, 0, b.shape[0] - 1)],
                           -1)

    return _int32(torch.stack([last_val(_mode_transfers(E)),
                               last_val(_flag_transfers(E))]))


def iso_pre_lanes(b: torch.Tensor, n, entry_mode=0, entry_flag=-1,
                  effect_lo: int = 0):
    """Orbit-free ISO-2022-JP lanes, step array and state_hot, decoded
    from entry state (entry_mode, entry_flag) with mode and flag effects
    before `effect_lo` masked out (the entry state sums them up).
    `lanes & orbit` gives iso2022_lanes; entry (0, -1) with effect_lo 0
    is the whole-stream decode."""
    b = b.to(torch.int32)
    cap = b.shape[0]
    n = cap if n is None else int(n)
    E = _iso_escapes(b, n)
    idx = E["idx"]
    have1 = E["have1"]
    b1 = E["b1"]
    valid_esc = E["valid_esc"]
    trunc_esc = E["trunc_esc"]
    invalid_esc = E["invalid_esc"]
    data = E["data"]
    inv_far = invalid_esc & (E["e1_28"] | E["e1_24"])  # bad e2: pushback 2
    inv_near = invalid_esc & ~(E["e1_28"] | E["e1_24"])  # bad e1: pushback 1

    # --- mode and flag prefix compositions, in one scan --------------
    # A valid escape at i sets the mode from position i+3 on. The flag's
    # transfers are {identity=-1, clear=0, set=1}: any consumed data byte
    # clears; a valid escape sets at its END (i+2), so escapes strictly
    # after it see the flag. Escape-error bytes are identity (host
    # parity). Effects before effect_lo are already folded into
    # entry_mode and entry_flag.
    tval = torch.where(idx >= effect_lo, _mode_transfers(E), -1)
    fv = torch.where(idx >= effect_lo, _flag_transfers(E), -1)
    mpfx, fpfx = _scan_last_sets(_int32(tval), _int32(fv))
    mode = torch.where(mpfx >= 0, mpfx, int(entry_mode))

    # --- LEAD (jis0208 two-byte) segments ----------------------------
    lead_data = data & (mode == 3)
    in_range = (b >= 0x21) & (b <= 0x7E)
    next_is_data = _shift_left(data, 1, False)
    pair = lead_data & in_range & next_is_data
    dangle = lead_data & in_range & have1 & ~next_is_data  # ESC follows
    pend_lead = lead_data & in_range & ~have1  # stream end: pending
    t_in = (b1 >= 0x21) & (b1 <= 0x7E)
    pair_tbl = _table(_pair_cp_np(KIND_EUC_JP), b.device)
    pcp = pair_tbl.view(-1)[(b | 0x80) * 256 + (b1 | 0x80)]
    pair_cp = torch.where(t_in & (pcp >= 0), pcp, -1)

    # --- event chain steps (the orbit itself is the caller's) --------
    step = torch.ones(cap, dtype=torch.int32, device=b.device)
    step = torch.where(valid_esc, 3, step)
    step = torch.where(pair, 2, step)
    claim_rest = trunc_esc | pend_lead
    step = _int32(torch.where(claim_rest, torch.clamp(n - idx, min=1), step))

    # --- redundant-escape flag (output flag) ------------------------
    fp = _shift_right(fpfx, 1, -1)
    flag_before = torch.where(fp >= 0, fp, int(entry_flag)) == 1
    redundant = valid_esc & flag_before

    # --- event lanes -------------------------------------------------
    ok_ar = (b < 0x80) & (b != 0x0E) & (b != 0x0F)
    cp_roman = torch.where(b == 0x5C, 0x00A5,
                           torch.where(b == 0x7E, 0x203E, b))
    ok_kata = (b >= 0x21) & (b <= 0x5F)

    cp = torch.full((cap,), -1, dtype=torch.int32, device=b.device)
    cp = torch.where(data & (mode == 0) & ok_ar, b, cp)
    cp = torch.where(data & (mode == 1) & ok_ar, cp_roman, cp)
    cp = torch.where(data & (mode == 2) & ok_kata, 0xFF61 - 0x21 + b, cp)
    cp = _int32(torch.where(pair, pair_cp, cp))

    length = torch.ones(cap, dtype=torch.int32, device=b.device)
    length = torch.where(pair, 2, length)
    length = _int32(torch.where(redundant, 3, length))

    report_off = torch.zeros(cap, dtype=torch.int32, device=b.device)
    report_off = torch.where(pair | dangle | inv_near, 1, report_off)
    report_off = _int32(torch.where(inv_far | redundant, 2, report_off))

    pushback = torch.zeros(cap, dtype=torch.int32, device=b.device)
    pushback = torch.where(inv_near, 1, pushback)
    pushback = _int32(torch.where(inv_far, 2, pushback))

    is_event = data | invalid_esc | redundant | dangle
    pre_start = is_event & ~claim_rest

    lanes = Lanes(
        start=pre_start,
        valid=pre_start & (cp >= 0),
        length=length,
        cp=_int32(torch.where(pre_start, cp, -1)),
        report_off=report_off,
        pushback=pushback,
        pending=claim_rest,
    )
    state_hot = (E["esc_body"] | invalid_esc | E["trunc_span"]
                 | lead_data) & E["in_n"]
    return lanes, step, state_hot


def iso2022_lanes(b: torch.Tensor, n=None):
    """Per-byte event lanes for an ISO-2022-JP chunk decoded from mode
    ASCII at offset 0 (`b` may be padded, `n` is the real length).
    Returns (Lanes, state_hot).

    As for the CJK lanes, `start` is the resolved event chain (orbit of
    0); non-start positions carry no meaning. Valid escapes that are
    not redundant-escape errors produce no event; truncated escapes and
    dangling leads at the stream end are pending."""
    n = b.shape[0] if n is None else int(n)
    pre, step, state_hot = iso_pre_lanes(b, n)
    orbit = _orbit_mask(step, n)
    start = pre.start & orbit
    lanes = pre._replace(
        start=start,
        valid=pre.valid & orbit,
        cp=_int32(torch.where(start, pre.cp, -1)),
        pending=pre.pending & orbit,
    )
    return lanes, state_hot


def iso2022_state_hot_np(data: np.ndarray) -> np.ndarray:
    """numpy twin of the device `state_hot` mask (jax-free, for the
    host feed builder the ASan fuzz drives): escape spans + all
    LEAD-mode data bytes. Mirrors iso2022_lanes' formulas exactly."""
    b = np.asarray(data, np.uint8).astype(np.int32)
    n = len(b)
    if n == 0:
        return np.zeros(0, bool)
    b1 = np.concatenate([b[1:], [0]])
    b2 = np.concatenate([b[2:], [0, 0]])
    idx = np.arange(n)
    have1 = idx < n - 1
    have2 = idx < n - 2

    esc = b == 0x1B
    e1_28 = b1 == 0x28
    e1_24 = b1 == 0x24
    set28 = (b2 == 0x42) | (b2 == 0x4A) | (b2 == 0x49)
    set24 = (b2 == 0x40) | (b2 == 0x42)
    valid_esc = esc & have2 & ((e1_28 & set28) | (e1_24 & set24))
    esc_mode = np.where(b2 == 0x4A, 1, np.where(b2 == 0x49, 2, 0))
    esc_mode = np.where(e1_24, 3, esc_mode)
    trunc_esc = esc & (~have1 | ((e1_28 | e1_24) & have1 & ~have2))
    invalid_esc = esc & ~valid_esc & ~trunc_esc

    def shift_right(x, k, fill):
        out = np.full(n, fill, x.dtype)
        out[k:] = x[: n - k]
        return out

    tval = shift_right(np.where(valid_esc, esc_mode, -1), 3, -1)
    last = np.maximum.accumulate(np.where(tval >= 0, idx, -1))
    mode = np.where(last >= 0, tval[np.maximum(last, 0)], 0)

    esc_body = (valid_esc | shift_right(valid_esc, 1, False)
                | shift_right(valid_esc, 2, False))
    trunc_span = trunc_esc | shift_right(trunc_esc, 1, False)
    data_pos = ~esc_body & ~invalid_esc & ~trunc_span
    return esc_body | invalid_esc | trunc_span | (data_pos & (mode == 3))
