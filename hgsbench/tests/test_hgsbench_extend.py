"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries only: no file of the benchmark is edited."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from hgsbench import run as hrun

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_cell_config_traffic_and_metric_are_files_and_entries(
        tmp_path):
    shutil.copytree(ROOT / "hgsbench", tmp_path / "hgsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "hgsbench").rglob("*") if p.is_file()}

    # new files
    src = json.loads((tmp_path / "hgsbench/configs/"
                      "mc-block_small-3dgs.json").read_text())
    src["yaml"]["model_params"]["model_config"]["kwargs"]["n_offsets"] = 5
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
        json.dumps({"loss_gap": 1.0}))
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
    assert spec.cfg["model"]["n_offsets"] == 5
    assert spec.traffic["first_iter"] == 40001
    assert spec.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in spec.per_layer] == ["dummy.windows"]
    assert {m["name"] for m in spec.end_to_end} == {
        "train_views_per_s", "peak_mem_gib", "setup_s"}
    run = SimpleNamespace(out={"records": {"step_ms": [1.0, 2.0]}})
    assert hrun.reader("dummy.windows", tmp_path)(run) == 2.0
    # the files that were there are as they were
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
