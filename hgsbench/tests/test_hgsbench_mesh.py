"""The four-card training cell driven end to end at a tiny size on the
CPU: four ranks through `torch.distributed.run` over gloo, past the
harness's look for cards. Sound, it comes out correct; with the timed
path broken underneath in each of the ways a data-parallel step can
break, `correct` comes out false. A fault is planted in every rank's
process by a `sitecustomize` module on the ranks' `PYTHONPATH`, since
the ranks are processes of their own."""
from __future__ import annotations

import os
import time

import pytest
import torch

from hgsbench import control
from hgsbench import run as hrun
from hgsbench.tests import tiny

torch.set_num_threads(1)
CELL = "bs3d-train-tail-dp4"
SEED = 2 ** 31 + 78
PLANT = "from horizongs_tpu_torch.parallel import step as ps\n"
FAULTS = {
    # Adam leaves the state as it was
    "state_unchanged": "ps.adam_step = lambda params, grads, opt, lrs: opt\n",
    # half of the batch left out, the mean taken over the rest
    "half_batch": (
        "def _weights(self, cams):\n"
        "    h = self.n_data // 2\n"
        "    w = float(cams[self.mesh.d].loss_weight)\n"
        "    return (w if self.mesh.d < h else 0.0,\n"
        "            sum(float(c.loss_weight) for c in cams[:h]))\n"
        "ps.ShardedTrainStep._weights = _weights\n"),
    # the exchange between the cards left out: each rank keeps its own
    "no_exchange": "ps.reduce_sum = lambda x, group: x\n",
    # the rendered image altered where it is produced
    "altered_answer": (
        "_orig = ps.composite_fields_3dgs\n"
        "def _composite(*a, **k):\n"
        "    render, alphas, info = _orig(*a, **k)\n"
        "    return render + 1e-2, alphas, info\n"
        "ps.composite_fields_3dgs = _composite\n"),
}


# the JAX package loaded in every rank after its window
LOADED = ("import sys, types\n"
          "sys.modules['horizongs_tpu'] = types.ModuleType('horizongs_tpu')\n")


def measure(tmp_path, monkeypatch, fault=None, plant=None) -> dict:
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if fault is not None:
        plant = PLANT + FAULTS[fault]
    if plant is not None:
        (tmp_path / "sitecustomize.py").write_text(plant)
        monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
    spec = tiny.spec(CELL)
    assert spec.limits and spec.cell["chips"] == 4
    return hrun.measure(spec, SEED, 1.0, False, torch.device("cpu"),
                        t0=time.perf_counter())


def test_sound_run_is_correct(tmp_path, monkeypatch):
    r = measure(tmp_path, monkeypatch)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4
    d = r["_detail"]
    assert [x["rank"] for x in d["_ranks"]] == [0, 1, 2, 3]
    # every step a batch of four views, as many views as attempted
    assert r["attempted"] % 4 == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 tiny.spec(CELL).end_to_end}
    assert r["_forbidden"] == []


def test_a_rank_that_loaded_the_jax_package_is_reported(tmp_path,
                                                        monkeypatch):
    r = measure(tmp_path, monkeypatch, plant=LOADED)
    assert r["_forbidden"] == ["horizongs_tpu"]


def test_the_harness_refuses_what_a_rank_loaded(monkeypatch, capsys):
    """`run.main` prints no result and exits non-zero where a rank had
    loaded a JAX module, though the harness's own process has none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(hrun, "forbidden_modules", lambda: [])
    monkeypatch.setattr(hrun, "measure", lambda *a, **k: {
        "correct": True, "_forbidden": ["jax"], "_detail": {},
        "checks": {}})
    rc = hrun.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                    "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err


@pytest.mark.parametrize("cell, fault", [
    ("bs3d-train-densify", "no_exchange"), ("bs2d-train-tail", "no_exchange"),
    ("bs3d-view-fly", "altered_answer")])
def test_the_control_refuses_a_fault_the_cell_cannot_have(cell, fault):
    """A fault the cell has no place for (an exchange off a mesh, a
    training step's fault in the viewer) is refused, not read as the sound
    reference."""
    with pytest.raises(ValueError):
        control.readings(tiny.spec(cell), SEED, torch.device("cpu"), fault)
    with pytest.raises(SystemExit) as e:
        control.main(["--workload", cell, "--seeds", "1", "--fault", fault])
    assert e.value.code == 2


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    r = measure(tmp_path, monkeypatch, fault)
    assert not r["correct"], r["checks"]
