"""A checkout of the benchmark at tiny sizes for the CPU tests: a copy of
BENCHMARK.json and portbench/ beside a link to the program, with the
cells' configurations and traffic cut to a few hundred points, a small
film and a few frames."""

from __future__ import annotations

import json
import os
import shutil
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROGRAM = "pointcloud_render_tpu_torch"

TINY = {
    "traj_ball-1m": dict(points=300, scene=dict(width=96, height=54)),
}
TINY_TRAFFIC = {
    "traj_ball-1m.flythrough": dict(frames=[0, 220, 44], warm_frames=[0, 219],
                                    checked_frames=3),
}


def edit_json(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_root(tmp) -> str:
    """A tiny checkout under ``tmp``; returns its root."""
    root = os.path.join(str(tmp), "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, PROGRAM), os.path.join(root, PROGRAM))
    bench = os.path.join(root, "portbench")
    for name, sizes in TINY.items():
        def cut(c, sizes=sizes):
            for k, v in sizes.items():
                if isinstance(v, dict):
                    c[k].update(v)
                else:
                    c[k] = v
        edit_json(os.path.join(bench, "configs", f"{name}.json"), cut)
    for name, traffic in TINY_TRAFFIC.items():
        edit_json(os.path.join(bench, "workloads", f"{name}.json"),
                  lambda w, t=traffic: w["traffic"].update(t))
    return root


def run(root, cell, trace=0, seed=3000000017, capsys=None):
    """One CPU run of ``cell`` in the tiny checkout -> (exit code, the
    result dict or None)."""
    from portbench import harness

    code = harness.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", "0.5", "--trace", str(trace)],
                       time.perf_counter(), root, device="cpu")
    result = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        result = json.loads(out[-1]) if code == 0 and out else None
    return code, result
