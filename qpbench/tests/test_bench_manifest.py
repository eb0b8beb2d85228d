"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
leads to its files."""

import json
import re

import pytest

from qpbench import harness

MAN = harness.manifest()
WHY_RE = re.compile(r"^[^\t\n]{1,200}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH_RE.match(p) and not p.startswith("/") and ".." not in p
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert WHY_RE.match(word) and not word.startswith("/")
    assert len(json.dumps(MAN)) <= 64 * 1024


def _names(section):
    return [e["name"] for e in MAN[section]]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = _names(section)
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert harness.NAME_RE.match(e["name"]), e["name"]
        if "unit" in e:
            assert harness.UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert WHY_RE.match(e[key]), (e["name"], key)


def test_entries_have_just_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(harness.NAME_RE.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for key in ("config", "traffic"):
            assert harness.NAME_RE.match(w[key])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs_and_pairs():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"] == f"qpbench/configs/{c['name']}.json"
        data = harness.load_json("configs", f"{c['name']}.json")
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(_names("configs"))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("name", _names("workloads"))
def test_every_name_leads_to_its_files(name):
    cell = harness.Cell(name, MAN)
    assert cell.kind.setup and cell.solver.layer and cell.reference.solve
    assert cell.checks["limits"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_metric_workloads_exist_and_layers_are_named_alike():
    names = set(_names("workloads"))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", [])) <= names
    e2e = set(_names("end_to_end"))
    assert {"setup_s", "step_ms", "solve_ms", "solve_p95_ms"} <= e2e
    assert all(m["moves"] in e2e for m in MAN["per_layer"])
    assert next(m for m in MAN["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
