"""Finds a cell's files by the names BENCHMARK.json gives.

A cell names a configuration and a traffic mix; the configuration's file
names its data generators (datagen/<name>.py), the mix names its driver
(drivers/<name>.py), and each per-layer metric is read by
layers/<metric>.py.  Adding a cell, configuration or metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_file(kind: str, name: str):
    """The module portbench/<kind>/<name>.py, loaded by path (names may
    hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: no {kind} file {path}")
    mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in `cell`: listed there, or listing no
    cells at all."""
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"portbench: no workload {name!r} in "
                           f"BENCHMARK.json ({sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.mix = read_json(os.path.join(BENCH_DIR, "mixes",
                                          self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]

    def driver(self):
        return load_file("drivers", self.mix["driver"])

    def datagen(self, role: str):
        """The generator the configuration names for `role` (say
        "alignments" or "graph")."""
        if role not in self.config:
            raise KeyError(f"portbench: configuration "
                           f"{self.config_entry['name']} has no {role}")
        return load_file("datagen", self.config[role])
