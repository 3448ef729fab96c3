"""The device trace of one scan: `torch.profiler`'s chrome trace read
into device spans (kernels, copies, sets) and host spans (the port's
profiling scopes, opened as `record_function`s by the harness), and what
the result line takes from it."""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict

SCAN_SPAN = "portbench.scan"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_MAX = 96


def load(path: str) -> dict:
    """{"device": [(card, name, start_us, end_us)], "host": [(name,
    start_us, end_us)], "span": (start_us, end_us)} of a chrome trace;
    the span is that of the SCAN_SPAN annotation."""
    with open(path) as f:
        doc = json.load(f)
    device, host, span = [], [], None
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            card = int(e.get("args", {}).get("device", 0))
            device.append((card, e.get("name", ""), start, end))
        elif cat == "user_annotation":
            if e.get("name") == SCAN_SPAN:
                span = (start, end)
            else:
                host.append((e.get("name", ""), start, end))
    if span is None and device:
        span = (min(d[2] for d in device), max(d[3] for d in device))
    return {"device": device, "host": host, "span": span}


def busy_intervals(events: dict, card: int):
    """The union of card `card`'s device spans inside the scan span, as
    sorted disjoint (start, end) pairs in microseconds."""
    lo, hi = events["span"]
    spans = sorted((max(s, lo), min(e, hi)) for c, _, s, e in events["device"]
                   if c == card and e > lo and s < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(events: dict, card: int) -> float:
    return sum(e - s for s, e in busy_intervals(events, card)) / 1e6


def window_seconds(events: dict) -> float:
    lo, hi = events["span"]
    return (hi - lo) / 1e6


def device_summary(events, devices) -> dict:
    """`busy_s` averaged over the cards used, and `window_s`."""
    if not events or events["span"] is None or not devices:
        return {}
    busy = [busy_seconds(events, d) for d in devices]
    return {"busy_s": sum(busy) / len(busy),
            "window_s": window_seconds(events)}


def kernel_seconds(events: dict, needle: str) -> float:
    """Device seconds of the kernels whose name holds `needle`, summed
    over the cards."""
    return sum(e - s for _, name, s, e in events["device"]
               if needle in name) / 1e6


def breakdown(events) -> dict:
    """The ten device operations that took most time, summed by name,
    and card 0's idle time inside the scan summed by the innermost host
    scope open while it idled (the ten largest)."""
    if not events or events["span"] is None:
        return {"device_ops": [], "idle_gaps": []}
    ops = defaultdict(float)
    for _, name, s, e in events["device"]:
        ops[name[:NAME_MAX]] += (e - s) / 1e6
    gaps = defaultdict(float)
    lo, hi = events["span"]
    edges, names = _scope_timeline(events["host"])
    prev = lo
    for s, e in busy_intervals(events, 0) + [(hi, hi)]:
        if s > prev:
            # split the idle stretch where a host scope opens or closes
            j0 = bisect.bisect_right(edges, prev)
            j1 = bisect.bisect_left(edges, s)
            cuts = [prev] + edges[j0:j1] + [s]
            for a, b in zip(cuts[:-1], cuts[1:]):
                j = bisect.bisect_right(edges, (a + b) / 2) - 1
                name = names[j] if 0 <= j < len(names) else None
                gaps[name or "(no scope)"] += (b - a) / 1e6
        prev = max(prev, e)
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _scope_timeline(host):
    """(edges, names): the sorted times at which a host scope opens or
    closes, and for each stretch between two of them the innermost
    (latest opened) scope open there, or None."""
    marks = sorted([(s, 0, k) for k, (_, s, e) in enumerate(host)]
                   + [(e, 1, k) for k, (_, s, e) in enumerate(host)])
    edges, names, open_ = [], [], []  # open_: heap of (-start, k)
    closed = set()
    for t, kind, k in marks:
        if kind == 0:
            heapq.heappush(open_, (-host[k][1], k))
        else:
            closed.add(k)
        while open_ and open_[0][1] in closed:
            heapq.heappop(open_)
        name = host[open_[0][1]][0] if open_ else None
        if edges and edges[-1] == t:
            names[-1] = name
        else:
            edges.append(t)
            names.append(name)
    return edges, names
