"""The projection's readers, `render.project_ms.train` and
`render.project_card_pct.train`, on hand-built records: the median device
ms of `render.project` under `render.bin` (a calibration's projection,
under another parent, left out), the share of rows projected on the card
(100 for 3DGS on the card, 0 for surfels); None in a viewer cell, without
device times, and from a program that records neither (the parent of
the projection's kernels)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from hgsbench import run as hrun

NAMES = ("render.project_ms.train", "render.project_card_pct.train")


def sp(name, device, parent, request):
    return {"name": name, "request": request, "parent": parent,
            "host_ms": 1.0, "device_ms": device}


def record(card=True):
    spans = []
    for it, ms in ((1, 0.5), (2, 0.7), (3, 0.6)):
        spans += [sp("render.project", ms, "render.bin", it),
                  sp("render.bin", 20.0, "step.forward", it)]
    # a calibration's projection: not a training view's
    spans.append(sp("render.project", 9.0, "trainer.calibrate", 4))
    rows = [1000, 1000, 1000, 1000]
    return {"spans": spans,
            "counters": {"render.project_rows": rows,
                         "render.project_rows_card": (
                             rows if card else [0] * 4)}}


def fake(kind, rec):
    return SimpleNamespace(kind=kind, out={}, trace=None, sfu_rate=None,
                           model={}, program_spans=rec)


def read(name, run):
    return hrun.reader(name)(run)


def test_project_readers_on_the_card():
    run = fake("train", record())
    assert read("render.project_ms.train", run) == pytest.approx(0.6)
    assert read("render.project_card_pct.train", run) == pytest.approx(100.0)


def test_surfels_project_off_the_card():
    run = fake("train", record(card=False))
    assert read("render.project_card_pct.train", run) == pytest.approx(0.0)
    assert read("render.project_ms.train", run) == pytest.approx(0.6)


def test_project_readers_read_none_elsewhere():
    for name in NAMES:
        assert read(name, fake("view", record())) is None, name
        assert read(name, fake("train", {"spans": [], "counters": {}})) \
            is None, name
    rec = record()
    for s in rec["spans"]:
        s["device_ms"] = None
    assert read("render.project_ms.train", fake("train", rec)) is None
