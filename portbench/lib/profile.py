"""Device profile of a stretch of work: ``torch.profiler`` over the calls,
the device's busy time as the union of its kernel, copy and memset
intervals, the time of each device operation, the CUDA runtime calls the
host made, and the device's idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name[:limit]


def traced(fn):
    """Run ``fn`` under the profiler -> (fn's result, profile dict):
    ``busy_s`` and ``window_s`` (the host's clock around the calls and
    the final synchronise), ``device`` [(start us, end us, name)] in time
    order, ``runtime`` {CUDA runtime call: count}, ``host`` [(start us,
    end us, name)] of the host's torch operations.  The profiler's own
    cost lengthens the window (a launch-bound loop pays for every
    recorded launch, with or without the host's operations recorded): an
    idle share wants the untraced time of the same work
    (``metrics/device_idle_share.flythrough.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, summarize(events, window)


def summarize(events, window: float) -> dict:
    """The profile dict of ``traced`` from a chrome trace's events.  The
    runtime calls leave out the ``cudaDeviceSynchronize`` calls that end
    the trace: ``traced`` closes the window with one, and it is the
    benchmark's, not the program's."""
    device, host, calls = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                e.get("name", ""))
        if cat in DEVICE_CATS:
            device.append(span)
        elif cat == "cpu_op":
            host.append(span)
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls.append(span)
    device.sort()
    host.sort()
    calls.sort()
    while calls and calls[-1][2] == "cudaDeviceSynchronize":
        calls.pop()
    runtime = {}
    for _, _, name in calls:
        runtime[name] = runtime.get(name, 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b, _ in device:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return dict(busy_s=busy * 1e-6, window_s=window, device=device,
                runtime=runtime, host=host)


def device_ops(prof: dict, top: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    by_name = {}
    for a, b, name in prof["device"]:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def idle_gaps(prof: dict, top: int = 10):
    """[[what the host was doing, seconds]]: the device's idle gaps
    between its first and last operation, each named by the host's torch
    operation that overlaps it most ("host: no torch op" where none
    does), summed by name, the largest first."""
    dev, host = prof["device"], prof["host"]
    if not dev:
        return []
    starts = [h[0] for h in host]
    gaps, end = [], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    by_name = {}
    for a, b in gaps:
        best, name = 0.0, "host: no torch op"
        k = bisect.bisect_left(starts, b)
        for h0, h1, hn in host[max(0, k - 64):k]:
            overlap = min(b, h1) - max(a, h0)
            if overlap > best:
                best, name = overlap, hn
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]
