"""The SH colour evaluation's yardstick (`hgsbench/counts_sh.py`) and its
two readers, `render.sh_ms.train` and `render.sh_roofline.train`, on
hand-built records: a training stretch with SH colours reads them, an RGB
stretch (no span `render.sh`), a viewer run and a program without the
recorder read None. And the cell `ba-sh2-train-tail` at a tiny size on
the CPU: both sides at SH degree 2, correct under its limits; a broken
step, and the control's faults, not."""
from __future__ import annotations

import time

import pytest
import torch

from hgsbench import control, counts, counts_sh
from hgsbench import run as hrun
from hgsbench.tests import test_hgsbench_cells as cells
from hgsbench.tests import test_hgsbench_spans as spans
from hgsbench.tests import tiny

READERS = ("render.sh_ms.train", "render.sh_roofline.train")
CELL = "ba-sh2-train-tail"


def test_sh_least_time_of_the_cell():
    assert counts_sh.bytes_per_row(9) == 132
    # the table's 1,003,520 x 10 rows at degree 2: 1.32 GB over 3.35 TB/s
    rows = 10_035_200
    assert counts_sh.least_seconds(rows, 9) == pytest.approx(
        rows * 132 / counts.HBM_BYTES_PER_S)
    assert counts_sh.least_seconds(rows, 9) * 1e3 == pytest.approx(0.3954,
                                                                 abs=1e-4)


def sh_record(parent="render.bin"):
    """The training record of `test_hgsbench_spans` with one SH evaluation
    a step under `parent` (device ms 4, 2, 9; 1000 rows each at degree
    2)."""
    rec = spans.train_record(epoch=False)
    for it, ms in ((1, 4.0), (2, 2.0), (3, 9.0)):
        rec["spans"].append(spans.sp("render.sh", 1.0, ms, parent, it))
    rec["counters"].update({"render.sh_rows": [1000] * 3,
                            "render.sh_coeffs": [9] * 3})
    return rec


def run_of(kind, record):
    return spans.fake(kind, record, spans.train_out())


def test_sh_readers_on_a_training_stretch():
    run = run_of("train", sh_record())
    assert spans.read("render.sh_ms.train", run) == pytest.approx(4.0)
    least = 3 * 1000 * 132 / counts.HBM_BYTES_PER_S
    assert spans.read("render.sh_roofline.train", run) == pytest.approx(
        100.0 * least / 15e-3)


@pytest.mark.parametrize("name", READERS)
def test_sh_readers_read_nothing_without_a_span(name):
    # the RGB cells: no `render.sh`, no SH counter
    assert spans.read(name, run_of("train", spans.train_record())) is None
    # a span outside `render.bin`
    assert spans.read(name, run_of("train", sh_record(parent=None))) is None
    # a viewer run, and a program without the recorder
    assert spans.read(name, run_of("view", sh_record())) is None
    assert spans.read(name, run_of("train", {"spans": [],
                                             "counters": {}})) is None


def test_sh_roofline_needs_counters_paired_with_spans():
    rec = sh_record()
    rec["counters"]["render.sh_rows"].pop()
    assert spans.read("render.sh_roofline.train",
                      run_of("train", rec)) is None
    rec = sh_record()
    for sp in rec["spans"]:
        sp["device_ms"] = None          # a run without CUDA
    assert spans.read("render.sh_roofline.train",
                      run_of("train", rec)) is None


def test_the_cell_takes_both_readers_and_the_shared_ones():
    spec = hrun.resolve(hrun.load_manifest(), CELL)
    names = {m["name"] for m in spec.per_layer}
    assert set(READERS) <= names
    assert {"k2_roofline", "mfu.train", "render.decode_ms.train"} <= names
    assert [m["name"] for m in spec.end_to_end] == [
        "train_views_per_s", "peak_mem_gib", "setup_s"]
    rgb = hrun.resolve(hrun.load_manifest(), "bs3d-train-densify")
    assert not set(READERS) & {m["name"] for m in rgb.per_layer}


def measure(s) -> dict:
    torch.set_num_threads(1)
    return hrun.measure(s, cells.SEED, 1.0, False, torch.device("cpu"),
                        t0=time.perf_counter())


def test_the_cell_at_a_tiny_size_is_correct_at_degree_2():
    r = measure(tiny.spec(CELL))
    assert r["correct"], r["checks"]
    detail = r["_detail"]
    assert detail["_program"]["sh_degrees"] == [2, 2, 2]
    assert detail["_reference"]["sh_degrees"] == [2, 2, 2]


@pytest.mark.parametrize("fault", [cells._half_batch, cells._altered_answer],
                         ids=["half_batch", "altered_answer"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = measure(tiny.spec(CELL))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_the_controls_faults_fail_a_limit(fault):
    s = tiny.spec(CELL)
    nums = control.readings(s, cells.SEED, torch.device("cpu"), fault)
    ok, checks = hrun.judge(nums, s.limits)
    assert not ok, checks
