"""Each cell driven end to end at a tiny size on the CPU, past the
harness's look for a card: sound, it comes out correct; with the timed
path broken underneath in each way the cell can break, `correct` comes
out false. (The exchange between chips is no fault of these one-card
cells.)"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from hgsbench import run as hrun
from hgsbench.tests import tiny

torch.set_num_threads(1)
# a seed whose trainer takes an aerial view among the three set-up steps
# (statistics are taken on aerial views only)
SEED = 2 ** 31 + 78
TRAIN = ["bs3d-train-densify", "bs2d-train-tail"]


def measure(cell: str, seed: int = SEED) -> dict:
    spec = tiny.spec(cell)
    assert spec.limits, f"{cell} has no limits file"
    return hrun.measure(spec, seed, 1.0, False, torch.device("cpu"),
                        t0=time.perf_counter())


@pytest.mark.parametrize("cell", TRAIN + ["bs3d-view-fly"])
def test_sound_run_is_correct(cell):
    r = measure(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-2:] == ["checks", "_detail"]
    names = {m["name"] for m in tiny.spec(cell).end_to_end}
    assert set(r["metrics"]) == names


def _state_unchanged(monkeypatch):
    import horizongs_tpu_torch.train.step as step
    monkeypatch.setattr(step, "adam_step",
                        lambda params, grads, opt, lrs: opt)


def _half_batch(monkeypatch):
    import horizongs_tpu_torch.train.losses as losses
    h = tiny.SCENE["height"] // 2
    monkeypatch.setattr(losses, "l1_loss",
                        lambda a, b: torch.mean(torch.abs(a[:h] - b[:h])))


def _altered_answer(monkeypatch):
    import horizongs_tpu_torch.train.step as step
    orig = step.render

    def render(*a, **k):
        pkg = orig(*a, **k)
        pkg["render"] = pkg["render"] + 1e-2
        return pkg
    monkeypatch.setattr(step, "render", render)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _altered_answer],
                         ids=["state_unchanged", "half_batch",
                              "altered_answer"])
def test_broken_training_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = measure(cell)
    assert not r["correct"], r["checks"]


def _epoch_unchanged(monkeypatch):
    import horizongs_tpu_torch.train.trainer as trainer

    def run_densify(cfg, opt, state, iteration, report=None, **kw):
        report.update(added=0, pruned=0, decision_ms=0.0, grow_ms=0.0,
                      repack_ms=0.0)
        return state
    monkeypatch.setattr(trainer, "run_densify", run_densify)


def _epoch_altered_row(monkeypatch):
    import horizongs_tpu_torch.train.trainer as trainer
    orig = trainer.run_densify

    def run_densify(*a, **k):
        out = orig(*a, **k)
        with torch.no_grad():
            out.params.anchor[int(out.n) - 1] += 1e-3
        return out
    monkeypatch.setattr(trainer, "run_densify", run_densify)


def _stats_unchanged(monkeypatch):
    import horizongs_tpu_torch.train.step as step
    monkeypatch.setattr(step, "update_stats",
                        lambda opt, stats, *a, **k: stats)


@pytest.mark.parametrize("fault", [_epoch_unchanged, _epoch_altered_row,
                                   _stats_unchanged],
                         ids=["epoch_unchanged", "epoch_altered_row",
                              "stats_unchanged"])
def test_broken_densify_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = measure("bs3d-train-densify")
    assert not r["correct"], r["checks"]


def test_the_tiny_epoch_adds_or_prunes_rows():
    d = measure("bs3d-train-densify")["_detail"]["_epoch"]
    assert d["added"] + d["pruned"] > 0


def _altered_frame(monkeypatch):
    import horizongs_tpu_torch.viewer.server as server
    orig = server.quantize

    def quantize(image):
        q = orig(image)
        return np.where(q < 255, q + 1, q).astype(np.uint8)
    monkeypatch.setattr(server, "quantize", quantize)


def _half_frame(monkeypatch):
    import horizongs_tpu_torch.viewer.server as server
    orig = server.render_request

    def render_request(*a, **k):
        img = orig(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    monkeypatch.setattr(server, "render_request", render_request)


@pytest.mark.parametrize("fault", [_altered_frame, _half_frame],
                         ids=["altered_answer", "half_frame"])
def test_broken_viewer_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = measure("bs3d-view-fly")
    assert not r["correct"], r["checks"]
