"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

A run finds its cell in ``BENCHMARK.json`` and the cell's files by name:
``workloads/<cell>.json`` (its configuration, its entry, its traffic and
the limits of its checks), ``configs/<config>.json`` (the program's sizes
and knobs and the plain reference's scene), ``entries/<entry>.py`` (the
code that drives the path the window measures) and, with ``--trace 1``,
``metrics/<metric>.py`` for each per-layer metric of the cell.  Adding a
cell, a configuration or a metric is adding files.

A run: set-up (data from the seed, the kernel libraries, one warm call:
``setup_s``), the measured window (whole calls of the entry until
``--seconds`` have passed), with ``--trace 1`` the traced section (the
record the metric readers take, with the window's call times under
``window_calls_s``), the peak memory, the program's state freed, then the plain reference and the
comparison that decides ``correct``.  The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result.

An entry module provides ``setup(ctx) -> state``, ``step(state) ->
(units done, units tried)`` (one whole call of the traffic; a unit that
failed is tried and not done), ``end_to_end(state, units,
seconds) -> {metric: value}``, ``trace(state) -> record``,
``release(state)`` and ``check(state) -> (checks, record)``, where
``checks`` is a list of (name, value, limit) and a value above its limit
fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

from portbench.lib import imports, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Context:
    """What an entry gets: the seed, the device, the cell's files."""

    def __init__(self, seed, device, config, workload):
        self.seed = seed
        self.device = device
        self.config = config
        self.workload = workload
        self.traffic = workload["traffic"]


def load_module(path: str, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, bench: dict, name: str):
    """(cell entry of BENCHMARK.json, workload file, configuration file,
    entry module) of the cell ``name``; KeyError for an unknown cell."""
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    bench_dir = os.path.join(root, "portbench")
    workload = read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = read_json(os.path.join(bench_dir, "configs",
                                    f"{cell['config']}.json"))
    entry = load_module(os.path.join(bench_dir, "entries",
                                     f"{workload['entry']}.py"),
                        f"portbench_entry_{workload['entry']}")
    return cell, workload, config, entry


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that the cell reports: the
    end-to-end ones that list it or list no cells, the per-layer ones
    that list it."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0].strip() if out else "not read"


def run(argv, t_start: float, root: str = ROOT, device: str = "cuda") -> int:
    """One run; returns the exit code.  ``device="cpu"`` is for the CPU
    tests alone: it skips the look for a card and takes the program's
    plain walks."""
    args = parse(argv)
    bench_dir = os.path.join(root, "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json")
    cell, workload, config, entry = load_cell(root, bench, args.workload)
    bad = imports.loaded_forbidden()
    if bad:
        return fail(f"forbidden modules loaded with the harness and the "
                    f"reference: {bad}")
    bad = imports.reference_imports_program(os.path.join(bench_dir,
                                                         "reference"))
    if bad:
        return fail(f"the reference imports the program or JAX: {bad}")
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device: torch.cuda.is_available() is false",
                        3)
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"the cell needs {cell['chips']} cards, "
                        f"{torch.cuda.device_count()} present", 3)
    e2e, layer = cell_metrics(bench, args.workload)
    readers = {m["name"]: load_module(
        os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
        "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        for m in layer} if args.trace else {}
    ctx = Context(args.seed, torch.device(device), config, workload)

    state = entry.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    units, attempted, failed, calls = 0, 0, 0, []
    t0 = time.perf_counter()
    while True:
        done, tried = entry.step(state)
        units += done
        attempted += tried
        failed += tried - done
        elapsed = time.perf_counter() - t0
        calls.append(elapsed - sum(calls))
        if elapsed >= args.seconds:
            break
    values = dict(entry.end_to_end(state, units, elapsed), setup_s=setup_s)

    record = {}
    t1 = time.perf_counter()
    if args.trace:
        record = entry.trace(state)
        record["window_calls_s"] = calls
    t2 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    entry.release(state)
    checks, ref_record = entry.check(state)
    record.update(ref_record)
    print(f"portbench: set-up {setup_s:.3f} s, window {elapsed:.3f} s "
          f"({units} units in {len(calls)} calls of {min(calls):.3f}-"
          f"{max(calls):.3f} s), traced section {t2 - t1:.3f} s, reference and "
          f"comparison {time.perf_counter() - t2:.3f} s", file=sys.stderr)
    print("portbench: the window's calls, s: "
          + " ".join(f"{c:.4f}" for c in calls), file=sys.stderr)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    kind = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": kind, "count": int(cell["chips"]),
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed)}
    if args.trace:
        record["device_kind"] = kind
        metrics = {}
        for m in layer:
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        prof = record.get("profile")
        if prof is not None:
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": profile.device_ops(prof),
                                   "idle_gaps": profile.idle_gaps(prof)}
            syncs = {k: n for k, n in prof["runtime"].items()
                     if "Synchronize" in k}
            print(f"portbench: traced call {prof['window_s']:.4f} s, busy "
                  f"{prof['busy_s']:.4f} s, the window's calls' median "
                  f"{statistics.median(calls):.4f} s untraced; "
                  f"synchronising runtime calls {syncs}", file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in e2e}
    if device == "cuda":
        dev_info["card"] = power_limit()
    bad = imports.loaded_forbidden()
    if bad:
        return fail(f"forbidden modules loaded after the window: {bad}")
    result["metrics"] = metrics
    result["device"] = dev_info
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
