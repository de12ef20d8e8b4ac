"""The benchmark's harness: one run of one cell.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json``, whose ``loop`` names the loop in
``loops/<loop>.py``, and each metric's reader in ``metrics/<metric>.py``.
A run sets the loop up, runs the window (or, traced, a short window under
``torch.profiler``), reads the peak memory, frees the program's state,
compares the sampled outputs with the plain reference, and returns the
result line's fields.
"""
from __future__ import annotations

import heapq
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "yalla_tpu")
# entries of each list in the trace's breakdown
TOP = 10


def load_module(path):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    name = "perfbench_" + "_".join(Path(path).with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench, workload):
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"perfbench: no workload {workload!r} in "
                     f"BENCHMARK.json")


def end_to_end(bench, workload):
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench, workload):
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moves]


def load_cell(root, workload, seed, device):
    """The cell ``workload`` of the checkout at ``root``, found by name:
    ``(bench, cfg, traffic, loop)``, the loop set up from ``seed`` on
    ``device``."""
    root = Path(root)
    base = root / "perfbench"
    bench = read_json(root / "BENCHMARK.json")
    cell = cell_of(bench, workload)
    cfg = dict(read_json(base / "configs" / f"{cell['config']}.json"),
               root=str(root))
    traffic = read_json(base / "traffic" / f"{cell['traffic']}.json")
    loop = load_module(base / "loops" / f"{traffic['loop']}.py").Loop(
        cfg, traffic, seed, device)
    return bench, cfg, traffic, loop


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window(loop, seconds):
    """Intervals until ``seconds`` have passed (and at least the loop's
    least count), then the loop's close; the wall time of each interval
    (from the end of the last one) and of the whole window."""
    import torch
    cuda = loop.dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = last = time.perf_counter()
    intervals, cell_steps, steps = [], 0, 0
    while True:
        c, s = loop.interval()
        now = time.perf_counter()
        intervals.append(now - last)
        last = now
        cell_steps += c
        steps += s
        if now - t0 >= seconds and len(intervals) >= loop.min_intervals:
            break
    loop.close()
    if cuda:
        torch.cuda.synchronize()
    return SimpleNamespace(intervals=intervals, cell_steps=cell_steps,
                           steps=steps,
                           seconds=time.perf_counter() - t0)


def merged(spans):
    """Disjoint (start, end) intervals covering ``spans``, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy, host_events):
    """Seconds of each gap between busy stretches of the device, summed
    by the innermost host event under way at the gap's middle (``host
    (none)`` where none is)."""
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                  for a, b in zip(busy, busy[1:]) if b[0] > a[1])
    events = sorted(host_events)
    out, active, k = {}, [], 0
    for mid, length in gaps:
        while k < len(events) and events[k][0] <= mid:
            start, end, name = events[k]
            heapq.heappush(active, (-start, end, name))
            k += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "host (none)"
        out[name] = out.get(name, 0.0) + length * 1e-6
    return out


def traced(loop, intervals):
    """A window of ``intervals`` intervals under ``torch.profiler``: the
    device's busy seconds (the union of its operations), the traced
    window's wall seconds, device seconds and launches by operation, the
    idle gaps by host event, and the Heun steps it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    loop.trace_begin()
    torch.cuda.synchronize()
    steps = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(intervals):
            steps += loop.interval()[1]
        loop.close()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t_read = time.perf_counter()
    device, host = [], []
    per_op, launches = {}, {}
    events = prof.events()
    # a host span (record_function) is mirrored on the device's timeline
    # under its own name: it is not an operation of the device
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
            continue
        if e.name in host_names or e.name == "Activity Buffer Request" \
                or end <= start:
            continue
        device.append((start, end))
        per_op[e.name] = per_op.get(e.name, 0.0) + (end - start) * 1e-6
        launches[e.name] = launches.get(e.name, 0) + 1
    busy = merged(device)
    print(f"perfbench: traced window {window_s:.3f} s, its trace read in "
          f"{time.perf_counter() - t_read:.3f} s ({len(device)} device and "
          f"{len(host)} host events)", file=sys.stderr)
    loop.trace_end()
    return SimpleNamespace(
        busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=window_s,
        per_op=per_op, launches=launches, steps=steps,
        gaps=idle_gaps(busy, host))


def op_seconds(trace, names):
    """Device seconds of the operations whose name holds one of
    ``names``."""
    return sum(v for k, v in trace.per_op.items()
               if any(n in k for n in names))


def top(d):
    return [[k[:160], v] for k, v in sorted(d.items(),
                                           key=lambda kv: -kv[1])[:TOP]]


def run(root, workload, seed, seconds, trace, device="cuda", t_start=None,
        log=print):
    """One run of ``workload``; returns the result line as a dict."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    base = Path(root) / "perfbench"
    bench, cfg, traffic, loop = load_cell(root, workload, seed, device)
    try:
        setup_s = time.perf_counter() - t_start
        cuda = torch.device(device).type == "cuda"
        if trace:
            rec, tr = None, traced(loop, int(traffic["trace_intervals"]))
        else:
            rec, tr = window(loop, seconds), None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"perfbench: peak device memory {peak} bytes "
            f"(max_memory_allocated)")
        log(f"perfbench: loop counts {loop.counts}")
        if rec is not None:
            ms = sorted(1e3 * t for t in rec.intervals)
            log("perfbench: interval ms min {:.3f} p10 {:.3f} p50 {:.3f} "
                "p90 {:.3f} max {:.3f} over {} intervals".format(
                    ms[0], quantile(ms, 0.1), quantile(ms, 0.5),
                    quantile(ms, 0.9), ms[-1], len(ms)))
        loop.release()
        checks = loop.checks()
    finally:
        loop.cleanup()
    ctx = SimpleNamespace(window=rec, trace=tr, loop=loop, cfg=cfg,
                          traffic=traffic, setup_s=setup_s,
                          op_seconds=lambda names: op_seconds(tr, names))
    metrics = {}
    for m in (per_layer if trace else end_to_end)(bench, workload):
        value = load_module(base / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cfg["limits"]
    failed = int(checks["failed"])
    result = {
        "correct": is_correct(checks, limits),
        "attempted": len(rec.intervals) if rec else
        int(traffic["trace_intervals"]),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": top(tr.per_op),
                               "idle_gaps": top(tr.gaps)}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def is_correct(checks, limits):
    """Whether every compared number is there and within its limit."""
    return all(v is not None and v <= limits[k] for k, v in checks.items())


def quantile(values, q):
    """The ``q`` quantile of ``values`` (``statistics.quantiles``,
    inclusive method)."""
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q * 100) - 1]
