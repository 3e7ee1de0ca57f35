"""The colour head a configuration names, built by the harness: SH2
colours with view_dim 0, without and with an appearance table, driven
through the training and the viewer cells' drivers at a tiny size on the
CPU (the cells' files, the colour head changed). Sound runs come out
correct with the program and the reference at the same SH degree; a
broken step or frame does not. The RGB cells' tables stay as they were,
bit for bit."""
from __future__ import annotations

import hashlib
import time

import pytest
import torch

from hgsbench import control, scene
from hgsbench import run as hrun
from hgsbench.reference import check
from hgsbench.tests import test_hgsbench_cells as cells
from hgsbench.tests import tiny

torch.set_num_threads(1)
HEADS = list(tiny.COLOUR_HEADS)


def measure(s, seed: int = cells.SEED) -> dict:
    return hrun.measure(s, seed, 1.0, False, torch.device("cpu"),
                        t0=time.perf_counter())


# sha256 of `_digest` at seed 2**31 + 5, taken from the harness before it
# built colour heads other than RGB with a view direction
RGB_DIGESTS = {
    "bs3d-train-densify":
        "503876ede591edc0f6a76fcf39001238dacbccb9081b7664cd0fda2b29cc0cf4",
    "bs2d-train-tail":
        "503876ede591edc0f6a76fcf39001238dacbccb9081b7664cd0fda2b29cc0cf4",
    "bs3d-view-fly":
        "ea95f23e6277530e940cef1b219ccafa8e3a504ee9c1e031e4741245f516c3a1",
}


def _digest(t: scene.Tables) -> str:
    h = hashlib.sha256()
    for x in t[:7]:
        h.update(x.contiguous().numpy().tobytes())
    h.update(str(t.n).encode())
    for k in sorted(t.mlp):
        h.update(k.encode())
        for x in t.mlp[k]:
            h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


def _tables(s, seed: int = 2 ** 31 + 5) -> scene.Tables:
    g = torch.Generator()
    g.manual_seed(seed)
    return scene.make_tables(s.cfg, s.traffic["table"], g, "cpu")


@pytest.mark.parametrize("cell", list(RGB_DIGESTS))
def test_rgb_tables_are_bit_for_bit_as_before(cell):
    assert _digest(_tables(tiny.spec(cell))) == RGB_DIGESTS[cell]


@pytest.mark.parametrize("head", HEADS)
def test_tables_size_the_colour_head(head):
    s = tiny.colour_spec("bs3d-train-densify", head)
    t, rgb = _tables(s), _tables(tiny.spec("bs3d-train-densify"))
    m = s.cfg["model"]
    F, k, app = m["feat_dim"], m["n_offsets"], m["appearance_dim"]
    w1, _, w2, b2 = t.mlp["color"]
    assert w1.shape == (F + app, F)
    assert w2.shape == (F, 27 * k) and b2.shape == (27 * k,)
    assert t.mlp["opacity"][0].shape == (F, F)
    assert t.mlp["cov"][0].shape == (F, F)
    views = tiny.SCENE["aerial_views"] + tiny.SCENE["street_views"]
    if app:
        assert t.mlp["appearance"][0].shape == (views, app)
    else:
        assert "appearance" not in t.mlp
    # the table itself is the RGB configuration's
    for x, y in zip(t[:7], rgb[:7]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cell,degree", [("bs3d-train-densify", 1),
                                         ("bs2d-train-tail", 2)],
                         ids=["3dgs-1501", "2dgs-30001"])
@pytest.mark.parametrize("head", HEADS)
def test_sound_training_run_is_correct_at_the_schedule_degree(
        head, cell, degree):
    """From iteration 1501 (the densify cell's) and 30001 (the tail's)."""
    s = tiny.colour_spec(cell, head)
    r = measure(s)
    assert r["correct"], r["checks"]
    d = r["_detail"]
    assert d["_program"]["sh_degrees"] == [degree] * 3
    assert d["_reference"]["sh_degrees"] == [degree] * 3
    names = d["_reference"]["names"]
    assert ("appearance" in names) == bool(s.cfg["model"]["appearance_dim"])
    assert len(d["_program"]["change_norms"]) == len(names)


def test_sh_degree_follows_the_trainers_schedule():
    s = tiny.colour_spec("bs3d-train-densify", "sh2")
    assert [check.sh_degree_at(s.cfg, it)
            for it in (1, 999, 1000, 1501, 1999, 2000, 30001)] == \
        [0, 0, 1, 1, 1, 2, 2]
    assert check.sh_degree_at(tiny.spec("bs3d-train-densify").cfg,
                              1501) is None


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("fault", [cells._half_batch, cells._altered_answer],
                         ids=["half_batch", "altered_answer"])
def test_broken_training_step_is_not_correct(head, fault, monkeypatch):
    fault(monkeypatch)
    r = measure(tiny.colour_spec("bs3d-train-densify", head))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("head", HEADS)
def test_sound_viewer_run_is_correct_at_the_maximum_degree(head,
                                                           monkeypatch):
    """Both sides render with no active degree, so each evaluates the
    configuration's maximum."""
    import horizongs_tpu_torch.viewer.server as server
    seen = {"program": set(), "reference": set()}

    def spy(side, orig):
        def render(*a, **k):
            seen[side].add(k.get("active_sh_degree"))
            return orig(*a, **k)
        return render
    monkeypatch.setattr(server, "render", spy("program", server.render))
    monkeypatch.setattr(check, "render", spy("reference", check.render))
    r = measure(tiny.colour_spec("bs3d-view-fly", head))
    assert r["correct"], r["checks"]
    assert seen == {"program": {None}, "reference": {None}}


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("fault", [cells._half_frame, cells._altered_frame],
                         ids=["half_batch", "altered_answer"])
def test_broken_viewer_is_not_correct(head, fault, monkeypatch):
    fault(monkeypatch)
    r = measure(tiny.colour_spec("bs3d-view-fly", head))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("fault", ["tf32", "half_batch", "altered_answer"])
def test_control_runs_and_its_faults_fail_a_limit(head, fault):
    """`hgsbench.control` runs on an SH configuration, and its planted
    faults fail one of the limits it reads. (TF32 exists only on a card:
    here it is float32, so it is only run.)"""
    s = tiny.colour_spec("bs3d-train-densify", head)
    nums = control.readings(s, cells.SEED, torch.device("cpu"), fault)
    limits = {k: v for k, v in s.limits.items() if k in nums}
    assert limits
    ok, checks = hrun.judge(nums, limits)
    assert ok == (fault == "tf32"), checks
