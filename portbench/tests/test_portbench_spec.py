"""BENCHMARK.json against the contract's shape, and every name it holds
against the file the harness finds by it."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from tiny import ROOT, cell, run

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        mine = [m for m in e2e.values()
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine}
        assert len(mine) >= 2, w["name"]


def test_per_layer_metrics_move_a_metric_of_their_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moves = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moves.get("workloads", [w]), (m["name"], w)
    for w in bench["workloads"]:
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


@pytest.mark.parametrize("kind", ["workloads", "configs", "metrics"])
def test_every_name_resolves_to_its_file(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            with open(os.path.join(ROOT, c["file"])) as f:
                assert json.load(f)["name"] == c["name"]
            assert c["file"].startswith("portbench/")
    elif kind == "workloads":
        for w in bench["workloads"]:
            c = spec.Cell(w["name"])
            assert c.loop().SESSION
            assert c.limits["numbers"]
            assert w["chips"] == 1
    else:
        for w in bench["workloads"]:
            for trace in (False, True):
                for entry, reader in spec.Cell(w["name"]).metrics(trace):
                    assert callable(reader.read), entry["name"]


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    """A cell added as a new mix, a new limits file and a new entry in a
    copy of the benchmark runs with no other edit."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((root / "portbench/mixes/cv_nr.json").read_text())
    mix["shifts"] = [2]
    (root / "portbench/mixes/cv_nr_shift2.json").write_text(json.dumps(mix))
    shutil.copy(root / "portbench/limits/kde5.cv_nr.json",
                root / "portbench/limits/kde5.cv_nr_shift2.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "kde5.cv_nr_shift2", "config": "kde5_cv_10k",
         "traffic": "cv_nr_shift2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kde5.cv_nr" in m.get("workloads", []):
            m["workloads"].append("kde5.cv_nr_shift2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run(cell("kde5.cv_nr_shift2", str(root)))
    assert result["correct"]
    assert set(result["metrics"]) == {"family_scores_per_s", "setup_s"}
