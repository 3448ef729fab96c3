"""Decode events and the run-table feed from the device's lanes.

Counterpart: stringsext_tpu/ops/device_events.py - `runtable_feed`
:272-383 with its device compaction `_compact_fn` :60 and
`_fetch_compact` :90, the numpy helpers `_utf8_encode_cps` :130 and
`_assemble_feed` :158, the jax-free oracle `_feed_from_host_events` :219
with `_host_filter_tables` :203 and `_utf8_lead_np` :211, the padded
lanes `compute_lanes` :108 with `_bucket` :51, and the event backend
`lanes_to_events` :37 and `generate_events_device` :386. The reference
module imports jax when it loads, so the port keeps its own copies of the
numpy helpers (tests pin them to the originals).

The feed covers the reference's ten kinds: UTF-8, UTF-16LE/BE,
single-byte, the CJK kinds and ISO-2022-JP. Lanes, filter acceptance,
the report clamp and the compaction run on the caller's device, in
pieces, so that device memory follows the piece and not the input.
Compaction is `torch.nonzero` plus a gather in place of the reference's
position bitmask and packed scatter; positions are piece-relative int32
on the device and int64 on the host, so the feed has no 2 GiB limit (the
reference compacts on the host there, :347-354; the arrays are the same).
`compute_lanes` and so the event backend keep the four self-synchronising
kinds, as the reference's (:108-127).

The report clamp (the reference's `lax.cummax` and compare, :336-345)
is `_report_clamp`: the hand kernel `csrc/report_clamp.cu` for a CUDA
tensor, its plain version `_report_clamp_ref` (`torch.cummax`) for a CPU
tensor, one path for every kind.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import host_tensor, to_device
from ..encodings import (
    KIND_ISO_2022_JP,
    KIND_SINGLE_BYTE,
    KIND_UTF16BE,
    KIND_UTF16LE,
    KIND_UTF8,
    encoding_kind,
)
from ..engine.events import Events, generate_events
from ..utils import profiling
from . import classify
from .runs import accept_mask, filter_words

# The kinds with device lanes for the run-table feed: all ten of the
# reference's (device_events.py:31-34).
FEED_KINDS = (
    KIND_UTF8, KIND_UTF16LE, KIND_UTF16BE, KIND_SINGLE_BYTE,
    "big5", "euc-jp", "euc-kr", "gb18030", "shift_jis", "iso-2022-jp",
)
# The kinds `compute_lanes` serves (the reference's :121-127): the event
# chain of the others needs the whole stream's orbit.
LANES_KINDS = (KIND_UTF8, KIND_UTF16LE, KIND_UTF16BE, KIND_SINGLE_BYTE)


def _utf8_encode_cps(cps: np.ndarray):
    """Vectorized UTF-8 encoding of codepoints (1-4 bytes; astral cps
    come from UTF-16 surrogate pairs and gb18030 four-byte forms).
    Returns (payload_u8, co_int64) where co[k] is the payload offset of
    char k (len(cps)+1 entries)."""
    cps = cps.astype(np.int64)
    n1 = cps < 0x80
    n2 = (cps >= 0x80) & (cps < 0x800)
    n3 = (cps >= 0x800) & (cps < 0x10000)
    n4 = cps >= 0x10000
    lens = np.where(n1, 1, np.where(n2, 2, np.where(n3, 3, 4))).astype(np.int64)
    co = np.zeros(len(cps) + 1, np.int64)
    np.cumsum(lens, out=co[1:])
    out = np.empty(int(co[-1]), np.uint8)
    p = co[:-1]
    out[p[n1]] = cps[n1]
    out[p[n2]] = 0xC0 | (cps[n2] >> 6)
    out[p[n2] + 1] = 0x80 | (cps[n2] & 0x3F)
    out[p[n3]] = 0xE0 | (cps[n3] >> 12)
    out[p[n3] + 1] = 0x80 | ((cps[n3] >> 6) & 0x3F)
    out[p[n3] + 2] = 0x80 | (cps[n3] & 0x3F)
    out[p[n4]] = 0xF0 | (cps[n4] >> 18)
    out[p[n4] + 1] = 0x80 | ((cps[n4] >> 12) & 0x3F)
    out[p[n4] + 2] = 0x80 | ((cps[n4] >> 6) & 0x3F)
    out[p[n4] + 3] = 0x80 | (cps[n4] & 0x3F)
    return out, co


def _assemble_feed(cpos, clen, ccp, payload_is_input: bool):
    """Build the run-table feed arrays from the feedable accepted chars
    (ascending positions, byte lengths, codepoints).

    Runs are maximal chains of byte-contiguous chars. Slot layout: run
    r owns slots [co_base[r], co_base[r+1]) = its chars IN ORDER plus
    one SENTINEL slot; ip[slot] is the char's input byte offset
    (sentinel: the run's end), co[slot] its payload offset (sentinel:
    the run's payload end). So char k of run r spans input
    [ip[base+k], ip[base+k+1]) and payload [co[base+k], co[base+k+1]).

    `payload_is_input` (UTF-8): the decoded bytes ARE the input span,
    so co == ip and the payload buffer is the input itself (returned as
    None; the native layer passes the data pointer, enabling SE_INREF
    zero-copy emission)."""
    nch_total = len(cpos)
    if nch_total == 0:
        return None
    cpos = cpos.astype(np.int64)
    clen = clen.astype(np.int64)
    brk = np.empty(nch_total, bool)
    brk[0] = True
    np.not_equal(cpos[1:], cpos[:-1] + clen[:-1], out=brk[1:])
    run_first = np.flatnonzero(brk).astype(np.int64)
    n_runs = len(run_first)
    run_last = np.append(run_first[1:], nch_total) - 1
    rs = cpos[run_first]
    re = cpos[run_last] + clen[run_last]
    nch = run_last - run_first + 1
    co_base = np.zeros(n_runs + 1, np.int64)
    np.cumsum(nch + 1, out=co_base[1:])
    total_slots = int(co_base[-1])
    run_of_slot = np.repeat(np.arange(n_runs, dtype=np.int64), nch + 1)
    off = np.arange(total_slots, dtype=np.int64) - co_base[run_of_slot]
    cidx = run_first[run_of_slot] + off  # char index; run_last+1 at sentinel
    sent = off == nch[run_of_slot]
    ip = cpos[np.minimum(cidx, nch_total - 1)]
    ip[sent] = re[run_of_slot[sent]]
    if payload_is_input:
        return rs, re, co_base, ip, ip, None
    pay, pc = _utf8_encode_cps(ccp)
    co = pc[np.minimum(cidx, nch_total)]
    return rs, re, co_base, co, ip, pay


def _host_filter_tables(mission):
    """(af_tbl bool[128], ubf_tbl bool[64]) from the mission filter."""
    f = mission.filter
    af_tbl = np.array([bool((f.af >> c) & 1) for c in range(128)])
    ubf_tbl = np.array([bool((f.ubf >> b) & 1) for b in range(64)])
    return af_tbl, ubf_tbl


def _utf8_lead_np(cp):
    return np.where(
        cp < 0x80, cp,
        np.where(cp < 0x800, 0xC0 | (cp >> 6),
                 np.where(cp < 0x10000, 0xE0 | (cp >> 12),
                          0xF0 | (cp >> 18))))


def _feed_from_host_events(data: np.ndarray, mission, kind: str,
                           with_extras: bool):
    """jax-free twin builder: the same feed arrays from the host numpy
    event generators (used by the ASan fuzz, where jax-tracing paths
    are disabled; tests pin device == host)."""
    ev = generate_events(data, mission.encoding_name)
    n_ev = len(ev)
    if n_ev == 0:
        return None
    is_char = ev.cp >= 0
    # Multi-codepoint events (the four Big5 double-cp pairs) surface as
    # a primary row plus an in_len==0 extra at the same position; both
    # are excluded (the generic walk handles them exactly).
    extra = ev.in_len == 0
    primary_of_extra = np.zeros(n_ev, bool)
    if extra.any():
        primary_of_extra[:-1] = extra[1:] & (ev.pos[:-1] == ev.pos[1:])
    # Report-clamped chars (an earlier error's pushback inflated their
    # effective report past their own last byte) are excluded: the feed
    # lane derives reports from char contiguity.
    natural = ev.report == ev.pos + ev.in_len - 1
    af_tbl, ubf_tbl = _host_filter_tables(mission)
    cp = np.maximum(ev.cp, 0)
    acc = np.where(ev.cp < 0x80, af_tbl[np.minimum(cp, 127)],
                   ubf_tbl[_utf8_lead_np(cp) & 0x3F])
    feed = is_char & acc & natural & ~extra & ~primary_of_extra
    idx = np.flatnonzero(feed)
    ft = _assemble_feed(ev.pos[idx], ev.in_len[idx], ev.cp[idx],
                        kind == KIND_UTF8)
    if not with_extras:
        return ft
    if ft is None:
        return None
    # Hot-coverage extras: chars excluded from the feed runs but still
    # able to produce findings (multi-cp pairs regardless of filter,
    # and report-clamped accepted chars). For modal ISO-2022-JP also
    # every mode/phase-dependent byte (escape spans + LEAD-mode data):
    # the cold-window skipper requires skipped bytes to be mode- and
    # phase-neutral 1-byte events.
    ex_mask = np.zeros(len(data), bool)
    ex_i = extra | primary_of_extra | (is_char & acc & ~natural)
    np.add.at(ex_mask, ev.pos[ex_i].astype(np.int64), True)
    ex_len_at = np.ones(len(data), np.int64)
    np.maximum.at(ex_len_at, ev.pos[ex_i].astype(np.int64),
                  ev.in_len[ex_i].astype(np.int64))
    if kind == "iso-2022-jp":
        from .classify_iso2022 import iso2022_state_hot_np

        ex_mask |= iso2022_state_hot_np(data)
    ex = np.flatnonzero(ex_mask)
    return ft, (ex.astype(np.int64), ex_len_at[ex])


def _lanes(b: torch.Tensor, kind: str, encoding_name: str, n: int):
    """The classification lanes of one self-synchronising kind."""
    if kind == KIND_UTF8:
        return classify.utf8_lanes(b, n)
    if kind in (KIND_UTF16LE, KIND_UTF16BE):
        return classify.utf16_lanes(b, kind == KIND_UTF16BE, n)
    if kind == KIND_SINGLE_BYTE:
        return classify.single_byte_lanes(b, encoding_name, n)
    raise ValueError(f"no torch lanes for encoding kind {kind!r}")


def _bucket(n: int, minimum: int = 1024) -> int:
    """Pad target: the next power of two, at least `minimum` (the
    reference's one-compile-per-bucket shapes, kept so that lanes and run
    tables match it row for row)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def compute_lanes(data: np.ndarray, encoding_name: str,
                  device: torch.device):
    """The classification lanes of one chunk on `device`, zero-padded to
    its power-of-two bucket: arrays are bucket-sized and positions at or
    past len(data) start no event. None for an encoding kind outside
    LANES_KINDS, as in the reference."""
    kind = encoding_kind(encoding_name)
    if kind not in LANES_KINDS:
        return None
    n = len(data)
    b = torch.zeros(_bucket(n), dtype=torch.uint8, device=device)
    b[:n].copy_(host_tensor(data))
    profiling.count("bytes.to_card", n)
    return _lanes(b, kind, encoding_name, n)


def lanes_to_events(lanes: classify.Lanes, base: int = 0) -> Events:
    """Compact per-byte lanes into an event list: the events are
    selected on the lanes' device, then fetched."""
    starts = torch.nonzero(lanes.start & ~lanes.pending).reshape(-1)
    length, cp, report_off, pushback = (
        x[starts].cpu().numpy() for x in (lanes.length, lanes.cp,
                                          lanes.report_off, lanes.pushback))
    pos = starts.cpu().numpy().astype(np.int64) + base
    return Events(pos, length.astype(np.int32), cp.astype(np.int32),
                  pos + report_off, pushback.astype(np.int32))


def generate_events_device(data: np.ndarray, encoding_name: str,
                           device: torch.device) -> Events:
    """The decode events of `data` from lanes on `device`; the host
    generator for an empty input or an encoding kind without lanes, as in
    the reference."""
    if len(data) == 0:
        return generate_events(data, encoding_name)
    lanes = compute_lanes(data, encoding_name, device)
    if lanes is None:
        return generate_events(data, encoding_name)
    return lanes_to_events(lanes)


def _fetch(mask: torch.Tensor, base: int, *lanes: torch.Tensor):
    """Device compaction: positions where `mask` is set, plus `base`
    (int64), and the `lanes` values there, as numpy arrays. The host
    waits on the card at the `nonzero` and at each copy back."""
    profiling.count("card.syncs", 2 + len(lanes))
    pos = torch.nonzero(mask).reshape(-1)
    return ((pos.cpu().numpy() + base),) + tuple(
        x[pos].cpu().numpy() for x in lanes)


# A byte's lanes depend on at most 3 bytes before it (UTF-8 claims, the
# UTF-16 pair trail) and 3 after it, so a chunk scanned with this much
# context on each side gives exactly the lanes of the whole stream.
_HALO = 4
# The chain kinds' piece window, as the mesh's shards
# (stringsext_tpu/parallel/mesh.py:63-64): bytes before the piece (an
# ISO-2022-JP escape that ends there, the LEAD pair's lookback) and after
# it (every lookahead, with room to spare).
LEFT_CTX = 4
RIGHT_HALO = 8


class _ChainState:
    """What the chain kinds carry from one piece to the next: the event
    chain's entry offset into the piece, and ISO-2022-JP's mode and
    redundant-escape flag at the piece's first effect position."""

    def __init__(self):
        self.entry_d = 0
        self.mode = 0
        self.flag = -1


def _chain_piece_lanes(data: np.ndarray, kind: str, start: int, end: int,
                       device, st: _ChainState):
    """(lanes, multi, state_hot) of the owned bytes [start, end) of a CJK
    or ISO-2022-JP piece (multi for the CJK kinds, state_hot for
    ISO-2022-JP, else None), with `st` advanced past the piece. The
    mesh's stages A-C (stringsext_tpu/parallel/mesh.py:205-261) one piece
    after another: the piece reads [start - LEFT_CTX, end + RIGHT_HALO)
    clipped to the stream and classifies with n = the bytes read, so the
    lookaheads and the claim-rest steps see the true end only in the
    last piece; the orbit runs from the carried entry and stops at the
    owned end, and the next entry is where the chain steps past it. At
    the lanes' starts (all the feed reads) they equal `cjk_lanes` /
    `iso2022_lanes` of the whole stream.

    Counted in `feed.chain.pieces`, in `feed.chain.iso_pieces` for an
    ISO-2022-JP piece (whose last-set scan `iso.scan.kernel` counts where
    it ran on the card's kernel), and in `feed.chain.orbit_kernel` where
    the orbit ran on the card's kernel; the host's waits on the card
    (ISO-2022-JP's state transfer, the next entry) are traced under the
    scope `feed.chain.wait`, inside the caller's `feed.chain`."""
    from .classify_cjk import _orbit_mask, _orbit_mask_blocked, cjk_pre_lanes
    from .classify_iso2022 import iso_pre_lanes, iso_state_transfer

    profiling.count("feed.chain.pieces")
    lo, hi = max(start - LEFT_CTX, 0), min(end + RIGHT_HALO, len(data))
    b = to_device(data[lo:hi], device)
    profiling.count("bytes.to_card", hi - lo)
    s0, own_end = start - lo, end - lo
    keep = slice(s0, own_end)
    multi = state_hot = None
    if kind == KIND_ISO_2022_JP:
        profiling.count("feed.chain.iso_pieces")
        pre, step, hot = iso_pre_lanes(b, hi - lo, st.mode, st.flag, s0)
        transfer = iso_state_transfer(b, hi - lo, s0, own_end)
        with profiling.scope("feed.chain.wait"):
            mode_t, flag_t = transfer.tolist()
        profiling.count("card.syncs")
        st.mode = mode_t if mode_t >= 0 else st.mode
        st.flag = flag_t if flag_t >= 0 else st.flag
        state_hot = hot[keep]
    else:
        pre, step = cjk_pre_lanes(b, kind, hi - lo)
    launches = _orbit_mask_blocked.launches
    orbit = _orbit_mask(step, own_end, s0 + st.entry_d)
    if _orbit_mask_blocked.launches != launches:
        profiling.count("feed.chain.orbit_kernel")
    if kind != KIND_ISO_2022_JP:
        # the multi-codepoint pairs are the valid events whose cp lane
        # is -1 (cjk_lanes' `multi & start`)
        multi = (pre.valid & (pre.cp < 0) & orbit)[keep]
    # the next entry: where the chain steps from its last owned position
    last_t = torch.max(torch.where(
        orbit, torch.arange(hi - lo, dtype=torch.int32, device=b.device), -1))
    with profiling.scope("feed.chain.wait"):
        last = int(last_t)
        nxt = (last + max(int(step[last]), 1) if last >= 0
               else s0 + st.entry_d)
    profiling.count("card.syncs", 2 if last >= 0 else 1)
    st.entry_d = nxt - own_end
    lanes = pre._replace(start=pre.start & orbit, valid=pre.valid & orbit,
                         pending=pre.pending & orbit)
    return classify.Lanes(*(x[keep] for x in lanes)), multi, state_hot


def _halo_piece_lanes(data: np.ndarray, kind: str, encoding_name: str,
                      start: int, end: int, device):
    """Lanes of the owned bytes [start, end) of a self-synchronising
    piece, scanned with _HALO bytes of context on each side."""
    n = len(data)
    lo, hi = max(start - _HALO, 0), min(end + _HALO, n)
    b = to_device(data[lo:hi], device)
    profiling.count("bytes.to_card", hi - lo)
    if (hi - lo) % 2:  # UTF-16 lanes need whole units; the pad is inert
        b = torch.cat([b, b.new_zeros(1)])
    keep = slice(start - lo, end - lo)
    return classify.Lanes(*(x[keep] for x in
                            _lanes(b, kind, encoding_name, hi - lo)))


_CLAMP_TILE = 4096  # positions a thread block of csrc/report_clamp.cu
_CLAMP_ARGS = [
    ctypes.c_void_p,  # start: bool[n]
    ctypes.c_void_p,  # pending: bool[n]
    ctypes.c_void_p,  # acc: bool[n]
    ctypes.c_void_p,  # report_off: int32[n]
    ctypes.c_void_p,  # length: int32[n]
    ctypes.c_int64,  # n
    ctypes.c_int64,  # lo
    ctypes.c_void_p,  # scratch: int64[ceil(n / 4096) + 1]
    ctypes.c_void_p,  # out: bool[n]
    ctypes.c_void_p,  # last: int32[1]
    ctypes.c_int,  # device index
    ctypes.c_void_p,  # cudaStream_t
]


def _report_clamp_ref(start, pending, acc, report_off, length, lo: int):
    """Plain torch version of `_report_clamp` (the running max by
    `torch.cummax`), on any device: the CPU's feed, the card's
    comparison."""
    idx = torch.arange(acc.shape[0], dtype=torch.int32, device=acc.device)
    rep = torch.where(start & ~pending, idx + report_off, -1)
    rep_max = torch.clamp(torch.cummax(rep, dim=0).values, min=lo)
    return acc & (rep_max == idx + length - 1), rep_max[-1]


def _report_clamp(start, pending, acc, report_off, length, lo: int):
    """The feed's report clamp over a piece of n positions: (feedable,
    last). The effective report of position i is the running max M[i] of
    `lo` and the event reports j + report_off[j] at j <= i (an event:
    start and not pending), the emitter's clock; a char whose effective
    report is past its own last byte is excluded, so feedable[i] =
    acc[i] and M[i] == i + length[i] - 1 (bool[n]), and last = M[n - 1]
    (an int32 0-d tensor), the max the next piece starts from. `start`,
    `pending` and `acc` are 1-D bool, `report_off` and `length` 1-D
    int32, all of length n on one device; -1 <= lo < 2**31. The kernel
    `csrc/report_clamp.cu` for CUDA tensors (counted in
    `_report_clamp.launches` and in the profiling counter
    `feed.clamp.kernel`), `_report_clamp_ref` for CPU tensors."""
    lanes = (start, pending, acc, report_off, length)
    n = acc.shape[0] if acc.dim() == 1 else -1
    for t, dtype in zip(lanes, (torch.bool,) * 3 + (torch.int32,) * 2):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != dtype:
            raise ValueError("the report clamp takes 1-D lanes of one "
                             "length: start, pending, acc bool, report_off, "
                             "length int32")
        if t.device != acc.device or not t.is_contiguous():
            raise ValueError("the report clamp's lanes must be contiguous "
                             "and on one device")
    lo = int(lo)
    if not 0 < n < 2 ** 31 or not -1 <= lo < 2 ** 31:
        raise ValueError(f"report clamp: n {n} or lo {lo} out of range")
    dev = acc.device
    if dev.type == "cpu":
        return _report_clamp_ref(start, pending, acc, report_off, length, lo)
    if dev.type != "cuda":
        raise ValueError(f"_report_clamp runs on cuda or cpu, not {dev}")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    last = torch.empty((), dtype=torch.int32, device=dev)
    # the look-back's ticket and one status word a tile (zeroed by the
    # launcher on the stream)
    scratch = torch.empty(-(-n // _CLAMP_TILE) + 1, dtype=torch.int64,
                          device=dev)
    from .. import _build

    stream = torch.cuda.current_stream(dev)
    _build.launch("report_clamp_launch", _CLAMP_ARGS,
                  *(t.data_ptr() for t in lanes), n, lo, scratch.data_ptr(),
                  out.data_ptr(), last.data_ptr(), dev.index,
                  stream.cuda_stream)
    _report_clamp.launches += 1
    profiling.count("feed.clamp.kernel")
    return out, last


_report_clamp.launches = 0


def _piece_feed(lanes: classify.Lanes, base: int, carry: int, af_w, ubf_w,
                with_extras: bool, multi=None, state_hot=None):
    """The feed of one piece whose first byte is stream byte `base`:
    ((pos, length, cp) of its feedable chars, (pos, length) of its extras
    or None, the running max of the reports after it). `carry` is that
    max before the piece; positions are int32 relative to the piece on
    the device and int64 once `base` is added on the host, so any base
    works. `multi` marks the CJK multi-codepoint pairs and `state_hot`
    ISO-2022-JP's mode- and phase-dependent bytes, where the kind has
    them."""
    with profiling.scope("feed.lanes"):
        acc = accept_mask(lanes, af_w, ubf_w)
        # A carry from before the piece below -1 changes nothing.
        feedable, last = _report_clamp(lanes.start, lanes.pending, acc,
                                       lanes.report_off, lanes.length,
                                       max(carry - base, -1))
    profiling.count("feed.pieces")
    # From here the host waits on the card; the extras' masks are
    # launched between the two fetches.
    with profiling.scope("feed.fetch"):
        feed = _fetch(feedable, base, lanes.length, lanes.cp)
        carry = base + int(last)
        profiling.count("card.syncs")
        if not with_extras:
            return feed, None, carry
        ev_extra = acc & ~feedable
        if multi is not None:
            ev_extra = ev_extra | multi
        ex_mask = ev_extra if state_hot is None else ev_extra | state_hot
        # Event-start extras carry their event length; state-hot-only
        # positions (mode/phase-dependent bytes, not starts) count 1.
        ex_len = torch.where(ev_extra, torch.clamp(lanes.length, min=1), 1)
        return feed, _fetch(ex_mask, base, ex_len), carry


def runtable_feed(data: np.ndarray, mission, device: torch.device,
                  with_extras: bool = False, chunk: int = 64 * 1024 * 1024):
    """EXACT accepted-char run tables plus decoded UTF-8 payload for
    one mission (the reference's `runtable_feed`, device=True). Returns
    (run_start, run_end, co_base, co, ip, payload) for
    native.native_scan's `runtable_feed` (payload None = the input
    itself, UTF-8), or None when there is no feedable run or the
    encoding kind is outside FEED_KINDS (as the reference,
    device_events.py:301-302).

    `with_extras=True` returns (feed, (extra_pos, extra_len)): the
    events the feed excludes that can still produce findings
    (report-clamped accepted chars, the Big5 multi-codepoint pairs) and,
    for ISO-2022-JP, every mode- or phase-dependent byte, which a hot map
    built from the runs must still cover.

    The device work runs over `chunk`-byte pieces (even, so UTF-16 units
    stay aligned). The self-synchronising kinds read _HALO bytes of
    context on each side; the CJK kinds and ISO-2022-JP carry their
    event chain and decoder state from piece to piece
    (`_chain_piece_lanes`); the report clamp carries its running
    maximum. The result is the whole stream's, while device memory grows
    with the piece, not with the input."""
    kind = encoding_kind(mission.encoding_name)
    if kind not in FEED_KINDS:
        return None
    if chunk <= 0 or chunk % 2:
        raise ValueError("runtable_feed: chunk must be a positive even size")
    n = len(data)
    if n == 0:
        return None
    af_w, ubf_w = filter_words(mission)
    chain = None if kind in LANES_KINDS else _ChainState()
    carry = -1  # running max of the reports before this piece
    feed_parts, extra_parts = [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        with profiling.scope("feed.lanes", end - start):
            if chain is None:
                lanes = _halo_piece_lanes(data, kind, mission.encoding_name,
                                          start, end, device)
                multi = state_hot = None
            else:
                with profiling.scope("feed.chain", end - start):
                    lanes, multi, state_hot = _chain_piece_lanes(
                        data, kind, start, end, device, chain)
        feed, extras, carry = _piece_feed(lanes, start, carry, af_w, ubf_w,
                                          with_extras, multi, state_hot)
        feed_parts.append(feed)
        extra_parts.append(extras)

    with profiling.scope("feed.join"):
        cpos, clen, ccp = (np.concatenate(p) for p in zip(*feed_parts))
    with profiling.scope("host.assemble", len(cpos)):
        ft = _assemble_feed(cpos, clen, ccp, kind == KIND_UTF8)
    if not with_extras:
        return ft
    if ft is None:
        return None
    with profiling.scope("feed.join"):
        ex, ex_len = (np.concatenate(p) for p in zip(*extra_parts))
        return ft, (ex, ex_len.astype(np.int64))
