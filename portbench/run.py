#!/usr/bin/env python3
"""portbench: the benchmark of stringsext_tpu_torch, whole CLI scans on
NVIDIA cards.

    python3 portbench/run.py --workload trio.dense64 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. `BENCHMARK.json` names the cell; its
configuration (`portbench/configs/<config>.json`: the stringsext flags),
its traffic mix (`portbench/traffic/<traffic>.json`: the image kind and
size, how many images, buffered or streamed) and its per-layer metrics
(`portbench/metrics/<metric>.py`) are found by name, so a new cell or
metric is a new file and an entry, never an edit here.

One run: make the images from the seed (numpy, written once into a
directory of its own under TMPDIR), warm up with one small scan of the cell's kind, then scan whole
images back to back, each through the port's normal entry
(`cli.parse_args` and `run.run(args, out, device="cuda")`), starting no
scan after `--seconds`, with the output of every scan kept in memory.
Then every output is checked (`check.py`) and the last line of standard
output is the result: with `--trace 0` the end-to-end metrics, with
`--trace 1` the per-layer metrics read from the port's profiling scopes
over the window and from a `torch.profiler` trace of its second scan.
The run sees only the first cards of the host, as many as the cell
asks for; without a card, or with fewer, it exits 3 and prints no result; if JAX, flax or the JAX package (`stringsext_tpu`,
`bench`, `__graft_entry__`) is loaded once the window has closed, it
exits 4.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stringsext_tpu", "bench",
             "__graft_entry__")
HBM_PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
TRACED_SCAN = 1  # the window's scan that the profiler records


def process_start() -> float:
    """The epoch second at which this process started (/proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix
    and per-layer metrics, each read from its own file."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"BENCHMARK.json ({', '.join(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(root, entry["file"])
        self.traffic = load_json(HERE, "traffic",
                                 self.workload["traffic"] + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def argv(self, path: str):
        extra = []
        if self.traffic["mode"] == "streamed":
            extra = ["--stream-file-min", str(self.traffic["stream_file_min"])]
        return list(self.config["argv"]) + extra + ["--", path]


def metric_reader(name: str):
    """The `read(ctx)` function of portbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def prepare_environment(trace: bool, chips: int) -> None:
    """Before torch and the port are imported: caches inside the
    checkout at fixed paths, the cell's cards, and the port's profiling
    scopes in a traced run."""
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible_cards(
        os.environ.get("CUDA_VISIBLE_DEVICES"), chips)
    os.environ["USE_FLAX"] = "0"
    for key in ("STRINGSEXT_PROFILE", "STRINGSEXT_RUNTABLE_FEED",
                "STRINGSEXT_ENGINE", "STRINGSEXT_STREAM_FILE_MIN",
                "STRINGSEXT_MESH"):
        os.environ.pop(key, None)
    if trace:
        os.environ["STRINGSEXT_PROFILE"] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def visible_cards(visible, chips: int) -> str:
    """The cards a cell may see: the first `chips` of those already
    visible (all of the host's when `visible` is None), so that the port,
    which spreads its hot map over every card it sees, runs on as many
    cards as the cell asks for on any host."""
    ids = [str(k) for k in range(chips)] if visible is None else \
        [s.strip() for s in visible.split(",") if s.strip()]
    return ",".join(ids[:chips])


def make_images(cell: Cell, seed: int, tmp: str):
    """[(path, image, marks)] of the cell's images, written to `tmp`."""
    from portbench import images

    t = cell.traffic
    make = images.KINDS[t["image"]]
    out = []
    for k in range(int(t["images"])):
        data, marks = make(int(t["image_bytes"]), images.image_seed(seed, k))
        path = os.path.join(tmp, f"portbench-{cell.name}-{k}.bin")
        with open(path, "wb") as f:
            data.tofile(f)
            f.flush()
            os.fsync(f.fileno())  # written back before the window opens
        out.append((path, data, marks))
    return out


class Scanner:
    """One whole scan through the port's CLI entry into a memory file."""

    def __init__(self, cell: Cell, device: str = "cuda"):
        from stringsext_tpu_torch import cli, run

        self.cell, self.device = cell, device
        self.cli, self.run = cli, run

    def scan(self, path: str):
        """The output bytes' file, or the exception the scan raised."""
        fd = os.memfd_create("portbench-out")
        out = os.fdopen(fd, "w+b")
        try:
            self.run.run(self.cli.parse_args(self.cell.argv(path)), out=out,
                         device=self.device)
            out.flush()
        except Exception as e:  # a failed scan is counted, not fatal
            out.close()
            return e
        return out


@contextlib.contextmanager
def scopes_as_record_functions():
    """Open a `torch.profiler.record_function` of each profiling scope's
    name inside it, so the trace names what the host was doing."""
    import torch
    from stringsext_tpu_torch.utils import profiling

    plain = profiling.scope

    @contextlib.contextmanager
    def scope(name, nbytes=0):
        with plain(name, nbytes), torch.profiler.record_function(name):
            yield

    profiling.scope = scope
    try:
        yield
    finally:
        profiling.scope = plain


def window(scanner: Scanner, imgs, seconds: float, trace: bool,
           clock=time.perf_counter):
    """Scan the images in turn, back to back, starting none after
    `seconds` (a traced run goes on to its traced scan). Returns (scans
    [(image index, output or exception, seconds)], window seconds, bytes
    read, (trace events, profiling seconds, image bytes) of the traced
    scan or None)."""
    scans, traced = [], None
    t0 = clock()
    k = 0
    while clock() - t0 < seconds or (trace and k <= TRACED_SCAN):
        i = k % len(imgs)
        path = imgs[i][0]
        s = clock()
        if trace and k == TRACED_SCAN:
            res, events, spent = profiled_scan(scanner, path)
            traced = (events, spent, len(imgs[i][1]))
        else:
            res = scanner.scan(path)
        scans.append((i, res, clock() - s))
        k += 1
    elapsed = clock() - t0
    nbytes = sum(len(imgs[i][1]) for i, _, _ in scans)
    return scans, elapsed, nbytes, traced


def scan_gbps(nbytes: int, seconds: float) -> float:
    """All the bytes the window's scans read, in GB (1e9), over the time
    from the first scan's start to the last scan's end."""
    return nbytes / seconds / 1e9


def profiled_scan(scanner: Scanner, path: str):
    """(output, trace events, profiling seconds by scope) of one scan
    under `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as trace_mod
    from stringsext_tpu_torch.utils import profiling

    before = scope_seconds(profiling)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        with torch.profiler.record_function(trace_mod.SCAN_SPAN):
            res = scanner.scan(path)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        events = trace_mod.load(out)
    return res, events, scope_seconds(profiling, before)


def scope_seconds(profiling, since=None) -> dict:
    """Seconds of each profiling scope so far, less those in `since`."""
    since = since or {}
    return {k: v[0] - since.get(k, 0.0) for k, v in profiling._stats.items()}


def memory_peak(devices) -> int:
    import torch

    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def forbidden_modules():
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None, device: str = "cuda", traffic=None) -> int:
    """The command. `device` and `traffic` (a traffic dict in place of
    the cell's file) exist for the CPU tests, which drive a whole run
    without a card at a small size."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    started = process_start()
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, a.workload)
    if traffic is not None:
        cell.traffic = traffic
    prepare_environment(bool(a.trace), cell.chips)

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() != cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {a.workload} needs {cell.chips} CUDA "
                  f"card(s), this machine has {n}", file=sys.stderr)
            return 3
        devices = list(range(cell.chips))
    else:
        devices = []

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        imgs = make_images(cell, a.seed, tmp)
        return measure(a, cell, imgs, started, devices, device)


def measure(a, cell, imgs, started, devices, device) -> int:
    import torch

    scanner = Scanner(cell, device)
    trace = bool(a.trace)
    ctx_trace = scopes_as_record_functions() if trace \
        else contextlib.nullcontext()
    with ctx_trace:
        from stringsext_tpu_torch.utils import profiling

        t_warm = time.time()
        warm = imgs[0][1][:int(cell.traffic["warmup_bytes"])]
        warm_path = imgs[0][0] + ".warm"
        warm.tofile(warm_path)
        try:
            res = scanner.scan(warm_path)
        finally:
            os.remove(warm_path)
        if isinstance(res, Exception):
            raise res
        res.close()
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        before = scope_seconds(profiling)
        setup_s = time.time() - started
        print(f"portbench: set-up {setup_s:.3f} s, of it the warm-up scan "
              f"{time.time() - t_warm:.3f} s", file=sys.stderr)
        scans, elapsed, nbytes, traced = window(scanner, imgs, a.seconds,
                                                trace)
        for d in devices:
            torch.cuda.synchronize(d)
        scopes = scope_seconds(profiling, before)
    peak = memory_peak(devices) if devices else 0
    print("portbench: scans " + " ".join(f"{t:.3f}" for _, _, t in scans)
          + f" s; window {elapsed:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4

    numbers, failed = verify(cell, scans, imgs, a.seed)
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    result = {"correct": correct, "attempted": len(scans), "failed": failed}
    if trace:
        from portbench import trace as trace_mod

        # The scopes' seconds and bytes leave out the profiled scan, which
        # the profiler slows; the device metrics read only that scan.
        events, spent, traced_bytes = traced
        scopes = {k: v - spent.get(k, 0.0) for k, v in scopes.items()}
        ctx = MetricContext(cell, scopes, nbytes - traced_bytes, events,
                            traced_bytes, devices)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = trace_mod.device_summary(events, devices)
        result["breakdown"] = trace_mod.breakdown(events)
    else:
        values = {"scan_GBps": scan_gbps(nbytes, elapsed),
                  "peak_device_GiB": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        dev_extra = {}
    result["metrics"] = metrics
    result["device"] = dict(device_info(devices), memory_peak_bytes=peak,
                            **dev_extra)
    result["check"] = numbers
    for name, v in numbers.items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def device_info(devices):
    import torch

    if not devices:
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": len(devices)}


class MetricContext:
    """What a per-layer metric reads: `scopes` (seconds of each profiling
    scope over the window's scans but the profiled one), `gb` (GB those
    scans read), `events` (the profiled scan's device and host spans,
    `trace.load`), `traced_bytes` (its image's bytes), the cell
    (`config`, `traffic`) and the devices."""

    def __init__(self, cell, scopes, nbytes, events, traced_bytes, devices):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.scopes = scopes
        self.gb = nbytes / 1e9
        self.events = events
        self.traced_bytes = traced_bytes
        self.devices = devices
        self.peak_bytes_per_s = HBM_PEAK_BYTES_PER_S

    def ms_per_gb(self, scope: str):
        t = self.scopes.get(scope, 0.0)
        return 1e3 * t / self.gb if t > 0 and self.gb > 0 else None


def regions_of(traffic, ref, data, marks, seed: int, i: int):
    """The regions of image `i` that the check compares: drawn from the
    run's seed, around the traffic's seams, the planted strings and
    uniform offsets (`check.sample_regions`)."""
    import numpy as np

    from portbench import check, images

    rng = np.random.default_rng(images.image_seed(seed, 1000 + i))
    every = int(traffic["seam_every"])
    return check.sample_regions(ref, data, marks,
                                list(range(every, len(data), every)),
                                traffic["check"], rng)


def verify(cell, scans, imgs, seed):
    """The numbers compared, each with its limit, and the failed scans:
    those that raised, and those whose output differs from the first
    output of their image or whose first output fails the check."""
    from portbench import check
    from portbench.reference.regions import Reference

    ref = Reference(cell.config["argv"])
    first, repeat_bad, raised = {}, 0, 0
    bad_image = set()
    for i, res, _ in scans:
        if isinstance(res, Exception):
            raised += 1
            print(f"portbench: scan of image {i} raised {res!r}",
                  file=sys.stderr)
            continue
        res.seek(0)
        out = res.read()
        res.close()
        if i not in first:
            first[i] = out
        elif out != first[i]:
            repeat_bad += 1
            bad_image.add(i)
    frame = grammar = order = lines_bad = lines = regions = 0
    for i, out in sorted(first.items()):
        _, data, marks = imgs[i]
        parsed = check.Parsed(out, ref)
        regs = regions_of(cell.traffic, ref, data, marks, seed, i)
        bad, total = check.region_mismatches(parsed, ref, data, regs)
        frame += parsed.frame_errors
        grammar += parsed.grammar_errors
        order += parsed.order_errors
        lines_bad += bad
        lines += total
        regions += len(regs)
        if parsed.frame_errors or parsed.grammar_errors or \
                parsed.order_errors or bad:
            bad_image.add(i)
    failed = raised + sum(1 for i, res, _ in scans
                          if not isinstance(res, Exception) and i in bad_image)
    numbers = {
        "scans_raised": {"value": raised, "limit": 0},
        "repeat_differs": {"value": repeat_bad, "limit": 0},
        "frame_errors": {"value": frame, "limit": 0},
        "grammar_errors": {"value": grammar, "limit": 0},
        "order_errors": {"value": order, "limit": 0},
        "region_lines_wrong": {"value": lines_bad, "limit": 0},
        "nothing_compared": {"value": int(lines == 0), "limit": 0},
    }
    print(f"portbench: checked {len(first)} image(s), {regions} regions, "
          f"{lines} reference lines", file=sys.stderr)
    return numbers, failed


if __name__ == "__main__":
    sys.exit(main())
