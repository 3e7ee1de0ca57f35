"""The readers of the program's spans and counters (`hgsbench/spans.py`)
on hand-built records: each returns its median or share, from the right
clock and under the right parent; `trainer.calibrate_ms` returns None on
a stretch without a step build, `densify.grow_ms` (the trainer's records)
on a window without an untraced epoch; every one returns None in the
other kind of cell and where the program kept no record (a program
without the recorder)."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from hgsbench import run as hrun
from hgsbench import spans as hspans

TRAIN = ("step.forward_ms", "step.backward_ms", "step.update_ms",
         "render.decode_ms.train", "render.bin_ms.train",
         "render.visible_pct.train", "trainer.calibrate_ms",
         "densify.grow_ms", "render.composite_ms.train",
         "render.instance_fill_pct.train", "render.decode_ms.mesh")
VIEW = ("viewer.render_ms_p50", "viewer.quantize_ms_p50",
        "viewer.send_ms_p50", "render.decode_ms.view", "render.bin_ms.view",
        "render.visible_pct.view", "render.composite_ms.view",
        "render.instance_fill_pct.view")


def sp(name, host, device, parent=None, request=1):
    return {"name": name, "request": request, "parent": parent,
            "host_ms": host, "device_ms": device}


def train_record(epoch=True):
    spans = []
    for it, k in ((1, 1.0), (2, 2.0), (3, 9.0)):
        spans += [sp("trainer.pick", 0.1, 0.2, request=it),
                  sp("render.decode", 50 + k, 10 * k, "step.forward", it),
                  sp("render.bin", 60 + k, 20 * k, "step.forward", it),
                  sp("render.composite", 1.0, 3 * k, "step.forward", it),
                  sp("step.forward", 99.0, 40 * k, request=it),
                  sp("step.backward", 98.0, 50 * k, request=it),
                  sp("step.update", 97.0, 5 * k, request=it),
                  sp("trainer.sync", 30.0, 0.01, request=it)]
    if epoch:
        spans += [sp("trainer.densify", 333.0, 340.0, None, 3),
                  # a calibration's decode: not a step's
                  sp("render.decode", 7.0, 1000.0, "trainer.calibrate", 4),
                  sp("trainer.calibrate", 120.0, 130.0, "trainer.build_step",
                     4),
                  sp("trainer.build_step", 121.0, 131.0, None, 4)]
    counters = {"render.anchor_rows": [1000, 1000, 1000],
                "render.anchors_visible": [500, 250, 750],
                "render.instances": [10, 30, 20],
                "render.instance_cap": [40, 40, 40]}
    return {"spans": spans, "counters": counters}


def train_out(epochs=((10, 300.0), (25, 900.0), (160, 500.0)),
              traced=(20, 59)):
    """The driver's output of a window from iteration 1001: densify epochs
    (row, grow ms) and the profiler's stretch's rows."""
    return {"window_first": 1001, "traced_rows": list(traced),
            "records": {"step_ms": [100.0] * 200,
                        "iteration_ms": [101.0] * 200,
                        "densify": [{"iteration": 1001 + row, "grow_ms": ms}
                                    for row, ms in epochs]}}


def view_record():
    spans = []
    for f, k in ((1, 1.0), (2, 3.0), (3, 2.0)):
        spans += [sp("viewer.receive", 5.0, 6.0, request=f),
                  sp("render.decode", 9.0, 4 * k, "viewer.render", f),
                  sp("render.bin", 9.0, 6 * k, "viewer.render", f),
                  sp("render.composite", 9.0, 2 * k, "viewer.render", f),
                  sp("viewer.render", 30.0, 35 * k, request=f),
                  sp("viewer.quantize", 20 * k, 21.0, request=f),
                  sp("viewer.send", 10 * k, 11.0, request=f)]
    return {"spans": spans,
            "counters": {"render.anchor_rows": [100, 100],
                         "render.anchors_visible": [10, 30],
                         "render.instances": [5, 7],
                         "render.instance_cap": [8, 8]}}


def fake(kind, record, out=None):
    return SimpleNamespace(kind=kind, out=out or {}, trace=None,
                           sfu_rate=None, model={}, program_spans=record)


def read(name, run):
    return hrun.reader(name)(run)


def test_training_readers():
    run = fake("train", train_record(), train_out())
    assert read("step.forward_ms", run) == pytest.approx(80.0)
    assert read("step.backward_ms", run) == pytest.approx(100.0)
    assert read("step.update_ms", run) == pytest.approx(10.0)
    assert read("render.decode_ms.train", run) == pytest.approx(20.0)
    assert read("render.bin_ms.train", run) == pytest.approx(40.0)
    assert read("render.visible_pct.train", run) == pytest.approx(50.0)
    assert read("trainer.calibrate_ms", run) == pytest.approx(120.0)
    # the epoch at row 25 lies in the stretch: left out
    assert read("densify.grow_ms", run) == pytest.approx(400.0)
    assert read("render.composite_ms.train", run) == pytest.approx(6.0)
    assert read("render.instance_fill_pct.train", run) == pytest.approx(
        50.0)


def test_mesh_decode_reader():
    """A sharded step opens no `step.forward`: its decodes are at the top
    of the record, which only `render.decode_ms.mesh` reads; a one-card
    step's decodes (and a calibration's) are not its."""
    spans = [sp("render.decode", 50.0, ms, None, it)
             for it, ms in ((1, 11.0), (2, 9.0), (3, 30.0))]
    spans += [sp("render.bin", 9.0, 25.0, None, 1),
              sp("trainer.pick", 0.1, 0.2, request=1)]
    run = fake("train", {"spans": spans, "counters": {}}, train_out())
    assert read("render.decode_ms.mesh", run) == pytest.approx(11.0)
    assert read("render.decode_ms.train", run) is None
    assert read("render.decode_ms.mesh",
                fake("train", train_record(), train_out())) is None


def test_densify_readers_are_none_without_an_epoch():
    run = fake("train", train_record(epoch=False),
               train_out(epochs=((25, 900.0),)))
    assert read("trainer.calibrate_ms", run) is None
    assert read("densify.grow_ms", run) is None
    assert read("step.forward_ms", run) == pytest.approx(80.0)
    run = fake("train", train_record(epoch=False), train_out(epochs=()))
    assert read("densify.grow_ms", run) is None


def test_viewer_readers():
    run = fake("view", view_record())
    assert read("viewer.render_ms_p50", run) == pytest.approx(70.0)
    assert read("viewer.quantize_ms_p50", run) == pytest.approx(40.0)
    assert read("viewer.send_ms_p50", run) == pytest.approx(20.0)
    assert read("render.decode_ms.view", run) == pytest.approx(8.0)
    assert read("render.bin_ms.view", run) == pytest.approx(12.0)
    assert read("render.visible_pct.view", run) == pytest.approx(20.0)
    assert read("render.composite_ms.view", run) == pytest.approx(4.0)
    assert read("render.instance_fill_pct.view", run) == pytest.approx(75.0)


@pytest.mark.parametrize("kind, names", [("view", TRAIN), ("train", VIEW)])
def test_readers_of_the_other_kind_return_none(kind, names):
    record = view_record() if kind == "view" else train_record()
    run = fake(kind, record, train_out() if kind == "train" else None)
    for name in names:
        assert read(name, run) is None, name


def test_device_readers_return_none_without_device_times():
    record = train_record()
    for s in record["spans"]:
        s["device_ms"] = None
    run = fake("train", record, train_out())
    for name in ("step.forward_ms", "step.backward_ms", "step.update_ms",
                 "render.decode_ms.train", "render.bin_ms.train",
                 "render.composite_ms.train"):
        assert read(name, run) is None, name
    assert read("trainer.calibrate_ms", run) == pytest.approx(120.0)


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    # what a program older than its recorder does: the import fails
    monkeypatch.setitem(sys.modules, "horizongs_tpu_torch.tracing", None)
    for kind, names in (("train", TRAIN), ("view", VIEW)):
        run = fake(kind, None)
        for name in names:
            assert read(name, run) is None, name
        assert run.program_spans == {"spans": [], "counters": {}}


def test_the_record_is_read_once_from_the_program():
    from horizongs_tpu_torch import tracing
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("viewer.quantize", request=1):
                pass
            tracing.count("render.anchor_rows", 8)
            tracing.count("render.anchors_visible", 2)
        run = fake("view", None)
        assert read("render.visible_pct.view", run) == pytest.approx(25.0)
        assert read("viewer.quantize_ms_p50", run) >= 0.0
        tracing.reset()
        # kept on the run: the reset after the first read changes nothing
        assert read("render.visible_pct.view", run) == pytest.approx(25.0)
        assert hspans.record(run)["spans"][0]["name"] == "viewer.quantize"
    finally:
        tracing.reset()
