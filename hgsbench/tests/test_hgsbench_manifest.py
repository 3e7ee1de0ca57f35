"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hgsbench import run as hrun

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    return hrun.load_manifest(ROOT)


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32
    assert all(text_ok(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_entry_keys():
    m = manifest()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(m["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert text_ok(w["why"])
    for mt in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(mt["name"]) and UNIT.match(mt["unit"])
        assert mt["better"] in ("lower", "higher")
        assert mt["source"] in SOURCES
    for mt in m["end_to_end"]:
        assert set(mt) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert mt["source"] in ("host_clock", "device_trace")
        assert 0.01 <= mt["bound"] <= 0.25
    for mt in m["per_layer"]:
        assert set(mt) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert text_ok(mt["layer"])
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in m["end_to_end"] + m["per_layer"]])
    for n in names:
        assert NAME.match(n), n
    for group in (m["configs"], m["workloads"],
                  m["end_to_end"] + m["per_layer"]):
        ns = [g["name"] for g in group]
        assert len(ns) == len(set(ns))
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    m = manifest()
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for w in m["workloads"]:
        spec = hrun.resolve(m, w["name"], ROOT)
        e2e = {x["name"] for x in spec.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer
        for pl in spec.per_layer:
            assert pl["moves"] in e2e, (w["name"], pl["name"])


def test_each_cell_resolves_its_files_by_name():
    m = manifest()
    for w in m["workloads"]:
        spec = hrun.resolve(m, w["name"], ROOT)
        assert spec.traffic["kind"] in ("train", "view")
        assert (ROOT / "hgsbench" / f"{spec.traffic['kind']}.py").is_file()
        assert spec.cfg["yaml"]["model_params"]["model_config"]["kwargs"]
        for pl in spec.per_layer:
            assert callable(hrun.reader(pl["name"]))


def test_per_layer_workloads_name_cells():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    for mt in m["end_to_end"] + m["per_layer"]:
        assert set(mt.get("workloads", [])) <= cells


def test_run_seconds_fits_the_full_check():
    m = manifest()
    per_run = m["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("field", ["why", "layer"])
def test_texts_are_single_lines(field):
    m = manifest()
    for e in m["workloads"] + m["configs"] + m["per_layer"]:
        if field in e:
            assert text_ok(e[field])
