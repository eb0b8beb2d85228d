"""Finding the pieces of a cell by name.

BENCHMARK.json names each cell's configuration and traffic mix, and each
metric.  The files behind the names:

- ``configs/<config>.json``: the deployment (problem family and sizes,
  solver and its options, reference, ``reduced``, ``assumed``);
- ``traffic/<traffic>.json``: the mix (its ``kind`` and parameters);
- ``kinds/<kind>.py``: the general generator of one kind of work;
- ``solvers/<solver>.py``: the adapter onto the port's entry points;
- ``problems/<generator>.py``: the problem family's distributions;
- ``reference/<reference>.py``: the plain reference;
- ``metrics/<metric>.py``: one reader per metric;
- ``checks/<workload>.json``: the limits that decide ``correct``.

A later cell, mix, kind or metric is new files and new entries: no file
here has to change.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` (a name may hold dots)."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    path = HERE / folder / f"{name}.py"
    key = f"qpbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its files read."""

    def __init__(self, name: str, man: dict = None):
        man = manifest() if man is None else man
        found = [w for w in man["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json("configs", f"{self.workload['config']}.json")
        self.traffic = load_json("traffic",
                                 f"{self.workload['traffic']}.json")
        self.checks = load_json("checks", f"{name}.json")
        self.end_to_end = [m for m in man["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in man["per_layer"] if self._has(m)]

    def _has(self, metric) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @property
    def kind(self):
        return load_module("kinds", self.traffic["kind"])

    @property
    def solver(self):
        return load_module("solvers", self.config["solver"])

    @property
    def reference(self):
        return load_module("reference", self.config["reference"])
