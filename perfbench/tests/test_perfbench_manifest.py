"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files."""

import importlib
import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
MAN = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) < 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])
    for w in MAN["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_run_seconds_fit_the_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_fields():
    names = set()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", []):
            assert w in CELLS


def test_configs_and_cells():
    confs = {}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in confs
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/")
        confs[c["name"]] = harness.load_json(ROOT, c["file"])
        assert confs[c["name"]]["name"] == c["name"]
        assert confs[c["name"]]["source"] == c["source"]
        assert confs[c["name"]]["reduced"] == c["reduced"]
    assert len({c["file"] for c in MAN["configs"]}) == len(confs)
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in MAN["workloads"]} == set(confs)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    c = harness.cell(MAN, workload)
    assert c["config"]["driver"]
    importlib.import_module(f"perfbench.drivers.{c['config']['driver']}")
    assert "shuffle" in c["traffic"]
    assert c["config"]["check"]["kkt_limit"] > 0
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell(MAN, "no.such.cell")
