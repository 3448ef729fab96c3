"""Classification lanes for the CJK multi-byte encodings (Big5, EUC-JP,
EUC-KR, GBK/gb18030, Shift_JIS) as torch ops, and the event-chain orbit.

Counterpart: stringsext_tpu/ops/classify_cjk.py - the cached tables
`_pair_cp_np` :54, `_multi_pair_np` :64, `_jis0212_np` :75, `_gather2`
:81, the orbit resolves `_orbit_mask_blocked` :91, `_orbit_masks_block0`
:188 and `_orbit_mask` :258, the accumulator `_C` :290, the classifiers
`_classify_two_byte` :318, `_classify_eucjp` :364, `_classify_gb18030`
:411 and `_cjk_classified` :482, and `cjk_pre_lanes` :501 and
`cjk_lanes` :521. Each equals its counterpart element for element, int32
lanes included. The tables come from the port's own `encodings/whatwg.py`.

Every position is classified as if an event started there; the true
event starts (these encodings do not resynchronise) are the orbit of the
start under `i -> i + step[i]`. `_orbit_mask` keeps the reference's
split: pointer doubling below 4 blocks of 512, the blocked resolve above.
`_orbit_mask_blocked` launches the hand kernel `csrc/orbit_resolve.cu`
for a CUDA tensor and runs its plain version `_orbit_mask_blocked_ref`
(the reference's algorithm: its two 512-step scans as Python loops, its
associative scan as a log-step composition) for a CPU tensor.
`_orbit_masks_block0`, the mesh's multi-start resolve, stays torch ops.

The gb18030 four-byte ranges map is the reference's telescoping
compare-sum in one step: with d[j] = rc[j] - rp[j] and rp sorted, the
sum telescopes to d[k] for k = the number of rp[1:] at or below p, which
`torch.bucketize(p, rp[1:], right=True)` gives; the codepoints are equal
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._device import host_tensor
from ..encodings import (
    KIND_BIG5,
    KIND_EUC_JP,
    KIND_EUC_KR,
    KIND_GB18030,
    KIND_SHIFT_JIS,
)
from .classify import Lanes, _shift_left

CJK_KINDS = (KIND_BIG5, KIND_EUC_JP, KIND_EUC_KR, KIND_GB18030,
             KIND_SHIFT_JIS)


@functools.lru_cache(maxsize=None)
def _pair_cp_np(kind: str) -> np.ndarray:
    """(256,256) int32 pair codepoint table (-1 = invalid). Multi-cp
    pairs (the four Big5 double-codepoint pointers) are left at -1 here
    and tracked by `multi_pair_mask`; the feed path excludes them."""
    from ..encodings import whatwg

    return np.ascontiguousarray(whatwg.pair_cp(kind), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _multi_pair_np(kind: str) -> np.ndarray:
    """(256,256) bool: pairs that decode to MORE than one codepoint."""
    from ..encodings import whatwg

    m = np.zeros((256, 256), dtype=bool)
    for key in whatwg.pair_multi(kind):
        m[key // 256, key % 256] = True
    return m


@functools.lru_cache(maxsize=None)
def _jis0212_np() -> np.ndarray:
    from ..encodings import whatwg

    return np.ascontiguousarray(whatwg.jis0212_cp(), dtype=np.int32)


def _table(arr: np.ndarray, device) -> torch.Tensor:
    return host_tensor(arr).to(device)


def _gather2(table: torch.Tensor, b: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """table[b, t] as a flat 65536-entry gather."""
    return table.view(-1)[b * 256 + t]


_ORBIT_BLOCK = 512  # blocked-resolve block width
_ORBIT_DEAD = 4  # transfer state: the chain ended (pending/stream end)
_ORBIT_FAR = 1 << 20  # local "chain gone" sentinel (>> block + max step)
_ORBIT_TILE = 16384  # positions a thread block of csrc/orbit_resolve.cu


def _orbit_cols(step: torch.Tensor, n: int):
    """The blocked resolves' shared set-up: (cols, in_n, nb, capp), where
    cols[j, k] is the offset in block k that the chain reaches from its
    offset j (FAR once a step reaches past `n`) and in_n[j, k] says that
    position is below `n`."""
    cap = step.shape[0]
    B = _ORBIT_BLOCK
    pad = (-cap) % B
    step_p = torch.clamp(step.to(torch.int32), min=1)
    if pad:
        step_p = torch.cat([step_p, step_p.new_ones(pad)])
    capp = cap + pad
    nb = capp // B
    idx = torch.arange(capp, dtype=torch.int32, device=step.device)
    far = torch.full_like(step_p, _ORBIT_FAR)
    nxt_off = (idx % B) + torch.where(idx + step_p <= n, step_p, far)
    cols = nxt_off.reshape(nb, B).T
    in_n = (idx < n).reshape(nb, B).T
    return cols, in_n, nb, capp


def _orbit_scan(r: torch.Tensor, cols: torch.Tensor, in_n: torch.Tensor,
                marks: bool = False):
    """The reference's 512-step `lax.scan` as a loop: the chain cursors
    `r` (any leading shape, blocks last) move through the block offsets.
    Returns the final cursors and, with `marks`, bool[B, ..., nb] of the
    offsets each chain visited below n."""
    out = []
    for j in range(_ORBIT_BLOCK):
        on = (r == j) & in_n[j]
        r = torch.where(on, torch.clamp(cols[j], max=_ORBIT_FAR), r)
        if marks:
            out.append(on)
    return r, (torch.stack(out) if marks else None)


def _exit_state(r: torch.Tensor) -> torch.Tensor:
    B = _ORBIT_BLOCK
    return torch.where((r >= B) & (r < B + 4), r - B,
                       torch.full_like(r, _ORBIT_DEAD)).to(torch.int32)


def _transfer_tables(exit_r4: torch.Tensor) -> torch.Tensor:
    """int32[nb, 5]: each block's exit state for entries 0..3 and DEAD."""
    T = _exit_state(exit_r4).T
    return torch.cat([T, torch.full_like(T[:, :1], _ORBIT_DEAD)], dim=1)


def _prefix_compose(T: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix composition of the [nb, 5] maps along the blocks
    (block k's map applied after those before it) by log-step doubling;
    composition of maps is exact, so this equals the reference's
    `associative_scan`."""
    pfx = T
    d = 1
    while d < T.shape[0]:
        later = pfx[d:]
        pfx = torch.cat([pfx[:d], torch.gather(later, 1, pfx[:-d].long())])
        d *= 2
    return pfx


def _orbit_mask_blocked_ref(step: torch.Tensor, n: int,
                            start: int) -> torch.Tensor:
    """Plain torch version of `_orbit_mask_blocked`: the reference's
    algorithm on any device (CPU tests; the card's comparison)."""
    cap = step.shape[0]
    cols, in_n, nb, capp = _orbit_cols(step, n)
    dev = step.device
    B = _ORBIT_BLOCK
    kidx = torch.arange(nb, dtype=torch.int32, device=dev)
    sb = start // B
    seeds = torch.stack(
        [torch.full((nb,), s, dtype=torch.int32, device=dev) for s in range(4)]
        + [torch.where(kidx == sb, start % B, _ORBIT_FAR).to(torch.int32)])
    exit_r, _ = _orbit_scan(seeds, cols, in_n)
    T = _transfer_tables(exit_r[:4])
    e0 = _exit_state(exit_r[4, min(sb, nb - 1)])

    ident = torch.arange(5, dtype=torch.int32, device=dev)
    Tshift = torch.where(kidx[:, None] > sb, T, ident[None, :])
    pfx = _prefix_compose(Tshift)
    prev = torch.cat([ident[None, :], pfx[:-1]])
    entry = prev[:, int(e0)]
    entry = torch.where(entry == _ORBIT_DEAD, _ORBIT_FAR, entry)
    entry = torch.where(kidx == sb, start % B, entry)
    entry = torch.where(kidx < sb, _ORBIT_FAR, entry).to(torch.int32)

    _, marks = _orbit_scan(entry, cols, in_n, marks=True)
    return marks.T.reshape(capp)[:cap]


_ORBIT_ARGS = [
    ctypes.c_void_p,  # step: int32[cap]
    ctypes.c_int64,  # cap
    ctypes.c_int64,  # n
    ctypes.c_int64,  # start
    ctypes.c_void_p,  # scratch: int32[ceil(cap / 16384) + 1]
    ctypes.c_void_p,  # out: bool[cap]
    ctypes.c_int,  # device index
    ctypes.c_void_p,  # cudaStream_t
]


def _orbit_mask_blocked(step: torch.Tensor, n: int, start: int) -> torch.Tensor:
    """bool[cap]: the positions below `n` that the chain from `start`
    reaches under i -> i + max(step[i], 1), by the blocked resolve (a
    chain that leaves a 512-byte block at an offset past 3 ends, as in
    the reference). `step` is int32[cap]; `n` and `start` are ints. The
    kernel `csrc/orbit_resolve.cu` for a CUDA tensor (counted in
    `_orbit_mask_blocked.launches`), `_orbit_mask_blocked_ref` for a CPU
    tensor."""
    if step.dim() != 1 or step.dtype != torch.int32:
        raise ValueError("step must be a 1-D int32 tensor")
    n, start = int(n), int(start)
    if start < 0:
        raise ValueError("start must be >= 0")
    if step.device.type == "cpu":
        return _orbit_mask_blocked_ref(step, n, start)
    if step.device.type != "cuda":
        raise ValueError(f"_orbit_mask_blocked runs on cuda or cpu, not "
                         f"{step.device}")
    cap = step.shape[0]
    nb = -(-cap // _ORBIT_BLOCK)
    if start >= nb * _ORBIT_BLOCK:  # no block holds the start: no chain
        return torch.zeros(cap, dtype=torch.bool, device=step.device)
    out = torch.empty(cap, dtype=torch.bool, device=step.device)
    step = step.contiguous()
    # the look-back's ticket and one status word a tile (zeroed by the
    # launcher on the stream)
    scratch = torch.empty(-(-cap // _ORBIT_TILE) + 1, dtype=torch.int32,
                          device=step.device)
    from .. import _build

    stream = torch.cuda.current_stream(step.device)
    _build.launch("orbit_resolve_launch", _ORBIT_ARGS, step.data_ptr(), cap,
                  n, start, scratch.data_ptr(), out.data_ptr(),
                  step.device.index, stream.cuda_stream)
    _orbit_mask_blocked.launches += 1
    return out


_orbit_mask_blocked.launches = 0


def _orbit_masks_block0(step: torch.Tensor, n: int,
                        starts: torch.Tensor) -> torch.Tensor:
    """Multi-start blocked chain resolve: bool[S, cap] orbit masks for S
    start offsets that all lie in block 0 (start < _ORBIT_BLOCK). One
    pass-1 scan gives the shared per-block transfers plus every start's
    block-0 exit; one prefix composition and one pass-2 scan give all S
    masks (the mesh's stage C reads its entry probes from one call)."""
    cap = step.shape[0]
    cols, in_n, nb, capp = _orbit_cols(step, n)
    dev = step.device
    starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    S = starts.shape[0]
    kidx = torch.arange(nb, dtype=torch.int32, device=dev)
    seeds = torch.cat([
        torch.stack([torch.full((nb,), s, dtype=torch.int32, device=dev)
                     for s in range(4)]),
        torch.where(kidx[None, :] == 0, starts[:, None],
                    _ORBIT_FAR).to(torch.int32),
    ])  # (4+S, nb)
    exit_r, _ = _orbit_scan(seeds, cols, in_n)
    T = _transfer_tables(exit_r[:4])
    e0s = _exit_state(exit_r[4:, 0])  # (S,)

    ident = torch.arange(5, dtype=torch.int32, device=dev)
    Tshift = torch.where(kidx[:, None] > 0, T, ident[None, :])
    pfx = _prefix_compose(Tshift)
    prev = torch.cat([ident[None, :], pfx[:-1]])  # (nb, 5)
    entry = prev[:, e0s.long()].T  # (S, nb)
    entry = torch.where(entry == _ORBIT_DEAD, _ORBIT_FAR, entry)
    entry = torch.where(kidx[None, :] == 0, starts[:, None],
                        entry).to(torch.int32)

    _, marks = _orbit_scan(entry, cols, in_n, marks=True)
    # marks: (B, S, nb) -> (S, nb, B) -> (S, capp)
    return marks.permute(1, 2, 0).reshape(S, capp)[:, :cap]


def _orbit_mask(step: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """bool[cap]: position is reachable from `start` under
    i -> i+step[i] (a true event start). From 4 blocks of 512 on, the
    blocked resolve (`_orbit_mask_blocked`, a hand kernel on the card);
    below, the reference's pointer doubling: after round k the mark set
    is closed under 2^k applications, so ceil(log2(cap)) + 1 rounds
    reach the fixpoint; positions at or past n funnel into a dump
    slot."""
    cap = step.shape[0]
    n, start = int(n), int(start)
    if cap >= 4 * _ORBIT_BLOCK:
        return _orbit_mask_blocked(step, n, start)
    dev = step.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    nxt = torch.clamp(idx + torch.clamp(step, min=1), max=cap)
    nxt = torch.where(idx < n, nxt, cap)
    J = torch.cat([nxt, nxt.new_full((1,), cap)]).long()
    marked = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    if start <= cap:  # an index past the end sets nothing, as in JAX
        marked[start] = True
    rounds = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)
    dump = torch.full_like(J, cap)
    for _ in range(rounds):
        marked = marked.index_fill(0, torch.where(marked, J, dump), True)
        J = J[J]
    return marked[:cap] & (idx < n)


class _C:
    """As-if-start classification accumulator (mirrors
    events_cjk._Classified, with torch tensors and report as an OFFSET
    from the position)."""

    def __init__(self, cap: int, device):
        kw = dict(dtype=torch.int32, device=device)
        self.step = torch.ones(cap, **kw)
        self.cp = torch.full((cap,), -1, **kw)
        self.pending = torch.zeros(cap, dtype=torch.bool, device=device)
        self.report_off = torch.zeros(cap, **kw)
        self.pushback = torch.zeros(cap, **kw)
        self.in_len = torch.ones(cap, **kw)
        self.multi = torch.zeros(cap, dtype=torch.bool, device=device)

    def set(self, mask, *, step=None, cp=None, report_off=None,
            pushback=None, in_len=None):
        for name, v in (("step", step), ("cp", cp),
                        ("report_off", report_off), ("pushback", pushback),
                        ("in_len", in_len)):
            if v is not None:
                cur = getattr(self, name)
                setattr(self, name, torch.where(mask, v, cur).to(torch.int32))


def _classify_two_byte(b, have1, kind: str) -> _C:
    """Big5 / EUC-KR / Shift_JIS (events_cjk._classify_two_byte)."""
    cap = b.shape[0]
    c = _C(cap, b.device)
    pair_cp = _table(_pair_cp_np(kind), b.device)

    if kind == KIND_SHIFT_JIS:
        single = b <= 0x80
        kana = (b >= 0xA1) & (b <= 0xDF)
        lead = ((b >= 0x81) & (b <= 0x9F)) | ((b >= 0xE0) & (b <= 0xFC))
    else:
        single = b < 0x80
        kana = torch.zeros_like(single)
        lead = (b >= 0x81) & (b <= 0xFE)

    c.set(single, cp=b)
    if kind == KIND_SHIFT_JIS:
        c.set(kana, cp=0xFF61 - 0xA1 + b)

    t = _shift_left(b, 1, 0)
    pcp = _gather2(pair_cp, b, t)
    # Multi-codepoint pairs: only Big5 has any (4 double-cp pointers) -
    # a handful of equality tests, as in the reference.
    multi_keys = sorted(int(k) for k in np.flatnonzero(
        _multi_pair_np(kind).reshape(-1)))
    is_multi = torch.zeros_like(single)
    if multi_keys:
        key = b * 256 + t
        for mk in multi_keys:
            is_multi = is_multi | (key == mk)
    pair_ok = lead & have1 & ((pcp >= 0) | is_multi)
    c.set(pair_ok, step=2, in_len=2, report_off=1, cp=pcp)
    c.multi = pair_ok & is_multi

    bad_pair = lead & have1 & ~pair_ok
    trail_ascii = t < 0x80
    c.set(bad_pair & trail_ascii, report_off=1, pushback=1)
    c.set(bad_pair & ~trail_ascii, step=2, in_len=2, report_off=1)

    c.pending = lead & ~have1
    return c


def _claim_rest(c: _C, idx, n) -> None:
    """A pending (truncated) sequence consumes every remaining byte."""
    c.step = torch.where(c.pending, torch.clamp(n - idx, min=1), c.step)


def _classify_eucjp(b, have1, have2, n) -> _C:
    cap = b.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=b.device)
    c = _C(cap, b.device)
    pair_cp = _table(_pair_cp_np(KIND_EUC_JP), b.device)
    t0212 = _table(_jis0212_np(), b.device)
    t1 = _shift_left(b, 1, 0)
    t2 = _shift_left(b, 2, 0)

    ascii_ = b < 0x80
    c.set(ascii_, cp=b)

    is8e = b == 0x8E
    kana_ok = is8e & have1 & (t1 >= 0xA1) & (t1 <= 0xDF)
    c.set(kana_ok, cp=0xFF61 - 0xA1 + t1, step=2, in_len=2, report_off=1)
    bad8e = is8e & have1 & ~((t1 >= 0xA1) & (t1 <= 0xDF))
    c.set(bad8e & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad8e & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend8e = is8e & ~have1

    lead = (b >= 0xA1) & (b <= 0xFE)
    pcp = _gather2(pair_cp, b, t1)
    pair_ok = lead & have1 & (pcp >= 0)
    c.set(pair_ok, cp=pcp, step=2, in_len=2, report_off=1)
    bad_pair = lead & have1 & ~pair_ok
    c.set(bad_pair & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad_pair & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend_lead = lead & ~have1

    is8f = b == 0x8F
    second_ok = is8f & have1 & (t1 >= 0xA1) & (t1 <= 0xFE)
    tcp = _gather2(t0212, t1, t2)
    tri_ok = second_ok & have2 & (tcp >= 0)
    c.set(tri_ok, cp=tcp, step=3, in_len=3, report_off=2)
    bad3 = second_ok & have2 & ~(tcp >= 0)
    c.set(bad3 & (t2 < 0x80), step=2, in_len=2, report_off=2, pushback=1)
    c.set(bad3 & ~(t2 < 0x80), step=3, in_len=3, report_off=2)
    bad2 = is8f & have1 & ~((t1 >= 0xA1) & (t1 <= 0xFE))
    c.set(bad2 & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad2 & ~(t1 < 0x80), step=2, in_len=2, report_off=1)
    pend8f = (is8f & ~have1) | (second_ok & ~have2)

    c.pending = pend8e | pend_lead | pend8f
    _claim_rest(c, idx, n)
    return c


@functools.lru_cache(maxsize=None)
def _gb18030_deltas():
    """(rp[1:] int32, d int32) of the four-byte ranges: d[k] = rc[k] -
    rp[k], the offset from pointer to codepoint in range k."""
    from ..encodings import whatwg

    rp_np, rc_np = whatwg.gb18030_ranges()
    rp_np = np.asarray(rp_np, np.int64)
    assert (np.diff(rp_np) >= 0).all(), "gb18030 range pointers unsorted"
    d_np = np.asarray(rc_np, np.int64) - rp_np
    return rp_np[1:].astype(np.int32), d_np.astype(np.int32)


def _classify_gb18030(b, have1, have2, have3, n) -> _C:
    cap = b.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=b.device)
    c = _C(cap, b.device)
    pair_cp = _table(_pair_cp_np(KIND_GB18030), b.device)
    t1 = _shift_left(b, 1, 0)
    t2 = _shift_left(b, 2, 0)
    t3 = _shift_left(b, 3, 0)

    ascii_ = b < 0x80
    c.set(ascii_, cp=b)
    # WHATWG gb18030 decoder step 7 (the GBK euro quirk): 0x80 is a
    # valid 1-byte U+20AC, not an error.
    c.set(b == 0x80, cp=0x20AC)

    lead = (b >= 0x81) & (b <= 0xFE)
    digit1 = (t1 >= 0x30) & (t1 <= 0x39)
    two_range = (t1 >= 0x40) & (t1 <= 0xFE) & (t1 != 0x7F)

    pcp = _gather2(pair_cp, b, t1)
    pair_ok = lead & have1 & two_range & (pcp >= 0)
    c.set(pair_ok, cp=pcp, step=2, in_len=2, report_off=1)
    bad_pair = lead & have1 & two_range & ~(pcp >= 0)
    c.set(bad_pair & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad_pair & ~(t1 < 0x80), step=2, in_len=2, report_off=1)

    bad2 = lead & have1 & ~digit1 & ~two_range
    c.set(bad2 & (t1 < 0x80), report_off=1, pushback=1)
    c.set(bad2 & ~(t1 < 0x80), step=2, in_len=2, report_off=1)

    four_start = lead & have1 & digit1
    third_ok = (t2 >= 0x81) & (t2 <= 0xFE)
    fourth_ok = (t3 >= 0x30) & (t3 <= 0x39)
    f_all = four_start & have3 & third_ok & fourth_ok
    p = ((b - 0x81) * 12600 + (t1 - 0x30) * 1260 + (t2 - 0x81) * 10
         + (t3 - 0x30))
    p_ok = (p <= 39419) | ((p >= 189000) & (p <= 1237575))
    quad_ok = f_all & p_ok
    rp1, d = (_table(x, b.device) for x in _gb18030_deltas())
    qcp = p + d[torch.bucketize(p, rp1, right=True)]
    c.set(quad_ok, cp=qcp, step=4, in_len=4, report_off=3)
    c.set(f_all & ~p_ok, step=4, in_len=4, report_off=3)
    third_bad = four_start & have2 & ~third_ok
    c.set(third_bad, report_off=2, pushback=2)
    fourth_bad = four_start & have3 & third_ok & ~fourth_ok
    c.set(fourth_bad, report_off=3, pushback=3)

    c.pending = ((lead & ~have1) | (four_start & ~have2)
                 | (four_start & have2 & third_ok & ~have3))
    _claim_rest(c, idx, n)
    return c


def _cjk_classified(b: torch.Tensor, kind: str, n=None) -> _C:
    """Shared as-if-start classification (orbit-free)."""
    b = b.to(torch.int32)
    cap = b.shape[0]
    n = cap if n is None else int(n)
    idx = torch.arange(cap, dtype=torch.int32, device=b.device)
    have1 = idx < n - 1
    have2 = idx < n - 2
    have3 = idx < n - 3

    if kind == KIND_EUC_JP:
        return _classify_eucjp(b, have1, have2, n)
    if kind == KIND_GB18030:
        return _classify_gb18030(b, have1, have2, have3, n)
    return _classify_two_byte(b, have1, kind)


def cjk_pre_lanes(b: torch.Tensor, kind: str, n):
    """Orbit-free per-byte lanes and the step array, for callers that
    resolve the event chain themselves. `lanes & orbit` (start, valid
    and pending each AND-ed with the orbit mask) gives cjk_lanes."""
    c = _cjk_classified(b, kind, n)
    pre_start = ~c.pending
    lanes = Lanes(
        start=pre_start,
        valid=pre_start & ((c.cp >= 0) | c.multi),
        length=c.in_len,
        cp=torch.where(c.multi, -1, c.cp),
        report_off=c.report_off,
        pushback=c.pushback,
        pending=c.pending,
    )
    return lanes, c.step


def cjk_lanes(b: torch.Tensor, kind: str, n=None):
    """Per-byte event lanes for a CJK chunk (padded to `b.shape[0]`; `n`
    is the real length). Returns (Lanes, multi) where `multi` marks
    events that decode to more than one codepoint (their cp lane is -1;
    the feed excludes them and the exact host walk handles them).

    `start` is the resolved event chain (orbit of 0), so non-start
    positions carry no meaning."""
    b = b.to(torch.int32)
    n = b.shape[0] if n is None else int(n)
    c = _cjk_classified(b, kind, n)
    start = _orbit_mask(c.step, n)
    valid = start & ~c.pending & ((c.cp >= 0) | c.multi)
    lanes = Lanes(
        start=start & ~c.pending,
        valid=valid,
        length=c.in_len,
        cp=torch.where(c.multi, -1, c.cp),
        report_off=c.report_off,
        pushback=c.pushback,
        pending=c.pending & start,
    )
    return lanes, c.multi & start
