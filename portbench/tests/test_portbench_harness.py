"""The harness end to end on the CPU at tiny sizes, through the program's
plain walks: each cell runs and is correct; a cell, a configuration and
a metric added as files alone are found and run; the faults a cell can
have make ``correct`` false; the control fails the comparison."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import control
from portbench.tests import tiny

CELLS = list(tiny.TINY_TRAFFIC)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def bench_json(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(root, cell, trace, capsys):
    code, result = tiny.run(root, cell, trace, capsys=capsys)
    assert code == 0
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["px_mismatch"] == {"value": 0, "limit": 0}
    bench = bench_json(root)
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = {m["name"] for m in bench["per_layer"]
             if cell in m["workloads"]}
    if trace:
        # A CPU run has no profile: only the span and counter readers find
        # something to read; the others leave their metric out.
        assert result["metrics"] and set(result["metrics"]) <= layer
    else:
        assert set(result["metrics"]) == e2e
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_added_cell_config_and_metric_run_as_files(tmp_path, capsys):
    """A configuration (a smaller cloud), a cell on it and a per-layer
    metric, each a new file plus its BENCHMARK.json entry, run without
    an edit to any file of the harness."""
    root = tiny.make_root(tmp_path)
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "configs", "traj_ball-1m.json")) as f:
        config = json.load(f)
    config.update(name="traj_ball-small", points=150)
    with open(os.path.join(bench_dir, "configs", "traj_ball-small.json"),
              "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "workloads",
                           "traj_ball-1m.flythrough.json")) as f:
        workload = json.load(f)
    workload.update(config="traj_ball-small")
    workload["traffic"].update(frames=[100, 220, 60])
    with open(os.path.join(bench_dir, "workloads",
                           "traj_ball-small.late.json"), "w") as f:
        json.dump(workload, f)
    with open(os.path.join(bench_dir, "metrics", "frames_traced.late.py"),
              "w") as f:
        f.write("def read(record):\n    return record.get('units')\n")

    def add(b):
        b["configs"].append(dict(b["configs"][0], name="traj_ball-small",
                                 file="portbench/configs/traj_ball-small.json"))
        b["workloads"].append(dict(b["workloads"][0], name="traj_ball-small.late",
                                   config="traj_ball-small", traffic="late"))
        for m in b["end_to_end"]:
            if "frames_per_s" == m["name"]:
                m["workloads"].append("traj_ball-small.late")
        b["per_layer"].append(dict(
            name="frames_traced.late", unit="frames", better="higher",
            source="program_counter", layer="flythrough loop",
            moves="frames_per_s", workloads=["traj_ball-small.late"]))
    tiny.edit_json(os.path.join(root, "BENCHMARK.json"), add)
    code, result = tiny.run(root, "traj_ball-small.late", 0, capsys=capsys)
    assert code == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    code, result = tiny.run(root, "traj_ball-small.late", 1, capsys=capsys)
    assert code == 0 and result["correct"] is True
    assert result["metrics"]["frames_traced.late"]["value"] == 2


def _alter_pixel(frames):
    out = [f.copy() for f in frames]
    for f in out:
        f[0, 0] = 255 - f[0, 0]
    return out


FAULTS = (
    "altered",  # an answer altered where it is produced
    "half",  # half of the cloud left out of every frame
    "unchanged",  # a step that returns its state unchanged: every frame
                  # is the first one
)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_make_correct_false(root, cell, fault, capsys, monkeypatch):
    from pointcloud_render_tpu_torch.run import trajectory

    original = trajectory.TrajectoryScanRenderer.render_frames

    def broken(self, positions, velocities, ids):
        if fault == "half":
            n = positions.shape[0] // 2
            return original(self, positions[:n], velocities[:n], ids)
        frames, pos = original(self, positions, velocities, ids)
        if fault == "altered":
            return _alter_pixel(frames), pos
        return [frames[0]] * len(frames), pos
    monkeypatch.setattr(trajectory.TrajectoryScanRenderer, "render_frames",
                        broken)
    code, result = tiny.run(root, cell, 0, capsys=capsys)
    assert code == 0
    assert result["correct"] is False
    assert result["checks"]["px_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(root, cell):
    for seed, value, limit in control.readings(cell, [1, 2, 3], root,
                                               device="cpu"):
        assert value > limit, (seed, value)


def test_no_card_exits_without_result(root, capsys, monkeypatch):
    import time

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.run(["--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], time.perf_counter(), root)
    assert code != 0
    assert capsys.readouterr().out == ""
