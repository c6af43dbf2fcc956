"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json`` (the file the configuration entry names);
- ``mixes/<traffic>.json``: the mix's parameters, with ``loop`` naming
  the general loop that reads them, ``loops/<loop>.py``;
- ``metrics/<metric>.py``: a reader with ``read(run)``;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


class Cell:
    """One workload of the benchmark and everything it names."""

    def __init__(self, name, root=ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.benchmark = json.load(f)
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.benchmark["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.mix = read_json(self.path("mixes", self.workload["traffic"],
                                       ".json"))
        self.limits = read_json(self.path("limits", name, ".json"))
        self.end_to_end = [m for m in self.benchmark["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.benchmark["per_layer"]
                          if name in m.get("workloads", [name])]

    def path(self, folder, name, suffix):
        return os.path.join(self.root, "portbench", folder, name + suffix)

    def loop(self):
        return importlib.import_module("portbench.loops." + self.mix["loop"])

    def metrics(self, trace):
        """[(entry, reader module)] of the metrics this cell reports."""
        entries = self.per_layer if trace else self.end_to_end
        return [(m, load_module(self.path("metrics", m["name"], ".py"),
                                "portbench_metric_" + m["name"]
                                .replace(".", "_")))
                for m in entries]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module of the file at ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
