"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of every name and unit, the files it names, a reader for
every per-layer metric, and the check's time budget at 24 cells."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    assert len(bench["command"]) <= 32
    assert all(text_ok(w) for w in bench["command"])


def test_names_units_and_entries(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        names.append(c["name"])
    assert len(set(names)) == len(names)
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert text_ok(w["why"])
        assert os.path.isfile(os.path.join(REPO, "portbench", "workloads",
                                           f"{w['name']}.json"))
        used.add(w["config"])
    assert used == set(names)
    cells = {w["name"] for w in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and text_ok(m["layer"])
        assert os.path.isfile(os.path.join(REPO, "portbench", "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_file_is_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(REPO, "portbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert PATH.match(rel), rel


def test_the_check_fits_at_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
