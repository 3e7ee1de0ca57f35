"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries only: no file of the benchmark is edited. A
configuration may change the table's widths or the colour head (SH2
colours with view_dim 0, as Horizon-GS's large-scene chunks name it),
and its cell then runs end to end."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from hgsbench import run as hrun
from hgsbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]

# (the configuration's changed kwargs, the new cell's limits, whether to
# run the cell at a tiny size)
CASES = {
    "n_offsets": ({"n_offsets": 5}, {"loss_gap": 1.0}, False),
    "sh2_view0": ({"color_attr": "SH2", "view_dim": 0},
                  {"loss1_gap": 6e-7, "grad_gap": 2e-5, "change_gap": 1.5e-5},
                  True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_new_cell_config_traffic_and_metric_are_files_and_entries(
        tmp_path, case):
    kwargs, limits, drive = CASES[case]
    shutil.copytree(ROOT / "hgsbench", tmp_path / "hgsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "hgsbench").rglob("*") if p.is_file()}

    # new files
    src = json.loads((tmp_path / "hgsbench/configs/"
                      "mc-block_small-3dgs.json").read_text())
    src["yaml"]["model_params"]["model_config"]["kwargs"].update(kwargs)
    (tmp_path / "hgsbench/configs/dummy-cfg.json").write_text(
        json.dumps(src))
    traffic = json.loads((tmp_path / "hgsbench/traffic/"
                          "train_tail.json").read_text())
    traffic["first_iter"] = 40001
    (tmp_path / "hgsbench/traffic/dummy_mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "hgsbench/metrics/dummy.windows.py").write_text(
        "def read(run):\n    return float(len(run.out['records']"
        "['step_ms']))\n")
    (tmp_path / "hgsbench/limits/dummy-cell.json").write_text(
        json.dumps(limits))
    # new entries
    man["configs"].append({"name": "dummy-cfg", "source": "a test",
                           "file": "hgsbench/configs/dummy-cfg.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "train_views_per_s":
            m["workloads"].append("dummy-cell")
    man["per_layer"].append({"name": "dummy.windows", "unit": "steps",
                             "better": "higher", "source": "program_span",
                             "layer": "train.trainer",
                             "moves": "train_views_per_s",
                             "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    spec = hrun.resolve(hrun.load_manifest(tmp_path), "dummy-cell",
                        tmp_path)
    for k, v in kwargs.items():
        assert spec.cfg["model"][k] == v
    assert spec.traffic["first_iter"] == 40001
    assert spec.limits == limits
    assert [m["name"] for m in spec.per_layer] == ["dummy.windows"]
    assert {m["name"] for m in spec.end_to_end} == {
        "train_views_per_s", "peak_mem_gib", "setup_s"}
    run = SimpleNamespace(out={"records": {"step_ms": [1.0, 2.0]}})
    assert hrun.reader("dummy.windows", tmp_path)(run) == 2.0
    if drive:
        torch.set_num_threads(1)
        r = hrun.measure(tiny.shrink(spec), 2 ** 31 + 78, 1.0, False,
                         torch.device("cpu"), t0=time.perf_counter())
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) == {"train_views_per_s", "peak_mem_gib",
                                     "setup_s"}
    # the files that were there are as they were
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
