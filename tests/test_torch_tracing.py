"""The port's spans and counters (`horizongs_tpu_torch.tracing`) on the
CPU: off, the trainer and the renderer record nothing and issue the very
ATen ops they issue with the span sites patched out; on (a profiler
recording), the trainer's, the step's, the render's (with SH colours,
`render.sh` and its counters; with RGB, neither), the densify epoch's and
the viewer's spans come with their parents and requests, and land in the profiler's chrome trace; the edge
cases of a profiler started or stopped inside an open span, and the cap.
Also `tools.timing.busy_union`, the busy time `device_profile` reports.
"""
from __future__ import annotations

import contextlib
import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.config import make_optim, make_pipeline
from horizongs_tpu_torch.data.synthetic import orbit_cameras, random_gaussians
from horizongs_tpu_torch.models.anchors import (
    anchor_lod_mask,
    init_anchor_state_from_points,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import init_mlps
from horizongs_tpu_torch.render import prefilter_anchors, render
from horizongs_tpu_torch.tools.timing import busy_union
from horizongs_tpu_torch.train.step import init_train_state
from horizongs_tpu_torch.train.trainer import Trainer
from horizongs_tpu_torch.viewer.server import (
    ViewerServer,
    frame_message,
    render_request,
    request_message,
)

torch.set_num_threads(1)

W = H = 32
CFG = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           voxel_size=0.3, fork=2, aerial_levels=2, street_levels=4,
           standard_dist=8.0, render_mode="RGB+ED")
STEP_SPANS = ("trainer.pick", "step.forward", "step.backward", "step.update",
              "trainer.sync")
RENDER_SPANS = ("render.decode", "render.bin", "render.composite")


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _model(**kwargs):
    cfg = ModelConfig(**{**CFG, **kwargs})
    pts = random_gaussians(300, seed=1, extent=1.0)["means"]
    state = init_anchor_state_from_points(cfg, pts, device="cpu")
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    return cfg, state, mlps


def _cameras():
    g = torch.Generator().manual_seed(2)
    return [c._replace(image=torch.rand(H, W, 3, generator=g))
            for c in orbit_cameras(6, width=W, height=H, device="cpu")]


def _trainer(tmp_path, stage="coarse"):
    """A trainer on a 300-point LOD model at 32x32, every view aerial and
    taking statistics, so a densify epoch comes every 2 iterations from
    iteration 3 on."""
    cfg, state, mlps = _model()
    cams = _cameras()
    base = None
    if stage == "fine":
        rows = (state.level[:state.n] < cfg.aerial_levels).numpy()
        base = {k: getattr(state, k)[:state.n].numpy()[rows].copy()
                for k in ("anchor", "offset", "feat", "scaling_log",
                          "rotation")}
    op = make_optim(iterations=100, start_stat=0, update_from=2,
                    update_until=1000, update_interval=2,
                    success_threshold=0.0, densify_grad_threshold=1e-9)
    scene = SimpleNamespace(
        device=torch.device("cpu"), model_path=str(tmp_path / "model"),
        stage=stage, base=base, frozen_mlps=False, frozen_appearance=False,
        weed_ratio=0.0, background=torch.zeros(3), cameras_extent=4.0,
        cam_infos=np.array([[*c.cam_center.tolist(), 1.0] for c in cams],
                           np.float32),
        train_state=init_train_state(state, mlps),
        get_train_cameras=lambda: cams, get_test_cameras=lambda: [],
        save=None)
    return Trainer(cfg, op, make_pipeline(vis_step=0), scene,
                   logger=SimpleNamespace(info=lambda *a, **k: None))


def _by_name(snap):
    out = {}
    for sp in snap["spans"]:
        out.setdefault(sp["name"], []).append(sp)
    return out


def _render_once(cfg, state, mlps, cam):
    with torch.no_grad():
        return render(cam, cfg, mlps, state, torch.zeros(3))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops_of_a_short_run(tmp_path):
    """The ATen ops of 4 trainer iterations (a step build, two densify
    epochs, the rebuild after the first) and one render."""
    tr = _trainer(tmp_path)
    cfg, state, mlps = _model()
    cam = _cameras()[1]
    with _Ops() as mode:
        tr.train(iterations=4, first_iter=1)
        _render_once(cfg, state, mlps, cam)
    return mode.ops, tr


def test_off_records_nothing_and_issues_the_same_ops(tmp_path, monkeypatch):
    assert not tracing.recording()
    ops, tr = _ops_of_a_short_run(tmp_path / "a")
    assert len(tr.records["densify"]) == 2
    assert tracing.snapshot() == {"spans": [], "counters": {}}

    monkeypatch.setattr(tracing, "span",
                        lambda name, request=None: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, value: None)
    monkeypatch.setattr(tracing, "recording", lambda: False)
    patched, _ = _ops_of_a_short_run(tmp_path / "b")
    assert len(ops) > 1000
    assert ops == patched


def test_trainer_spans_under_the_profiler(tmp_path):
    tr = _trainer(tmp_path)
    tr.train(iterations=1, first_iter=1)
    tr.profile_steps = (2, 2)
    tr.train(iterations=4, first_iter=2)
    prof_dir = tmp_path / "model" / "profile"
    with open(prof_dir / "spans.json") as f:
        saved = json.load(f)
    snap = tracing.snapshot()
    assert saved == snap

    by = _by_name(snap)
    for name in STEP_SPANS:
        assert sorted(sp["request"] for sp in by[name]) == [2, 3], name
        assert all(sp["parent"] is None for sp in by[name]), name
        assert all(sp["device_ms"] is None and sp["host_ms"] > 0
                   for sp in by[name])
    for name in RENDER_SPANS:
        fwd = [sp for sp in by[name] if sp["parent"] == "step.forward"]
        assert sorted(sp["request"] for sp in fwd) == [2, 3], name
    # iteration 3 densifies; iteration 4 (outside the window) rebuilds
    assert [sp["request"] for sp in by["trainer.densify"]] == [3]
    assert "trainer.build_step" not in by
    counters = snap["counters"]
    rows = tr.state.params.anchor.shape[0]
    assert counters["render.anchor_rows"] == [rows, rows]
    assert len(counters["render.anchors_visible"]) == 2
    assert all(0 < n <= cap for n, cap in zip(
        counters["render.instances"], counters["render.instance_cap"]))

    with open(prof_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    annotations = {e["name"] for e in events
                   if e.get("cat") == "user_annotation"}
    assert annotations >= set(STEP_SPANS + RENDER_SPANS)


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_densify_epoch_spans(tmp_path, stage):
    tr = _trainer(tmp_path, stage)
    tr.train(iterations=1, first_iter=1)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train(iterations=4, first_iter=2)
    assert [d["iteration"] for d in tr.records["densify"]] == [3]
    by = _by_name(tracing.snapshot())
    assert [(sp["parent"], sp["request"])
            for sp in by["trainer.densify"]] == [(None, 3)]
    # the epoch's phases are timed in its record, not by spans of their own
    assert not [name for name in by if name.startswith("densify.")]
    rep = tr.records["densify"][0]
    assert all(rep[k] > 0 for k in ("decision_ms", "grow_ms", "repack_ms"))
    assert [(sp["parent"], sp["request"])
            for sp in by["trainer.build_step"]] == [(None, 4)]
    assert [(sp["parent"], sp["request"])
            for sp in by["trainer.calibrate"]] == [("trainer.build_step", 4)]
    # the calibration's decodes sit under it, not under a step
    calib = [sp for sp in by["render.decode"]
             if sp["parent"] == "trainer.calibrate"]
    assert calib and all(sp["request"] == 4 for sp in calib)


def test_anchors_visible_is_the_lod_mask_and_prefilter_count():
    cfg, state, mlps = _model()
    for cam in _cameras()[:3]:
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            _render_once(cfg, state, mlps, cam)
        counters = tracing.snapshot()["counters"]
        mask, _ = anchor_lod_mask(cfg, state, cam.cam_center,
                                  cam.resolution_scale)
        mask = prefilter_anchors(cfg, state, cam, mask)
        assert counters["render.anchors_visible"] == [int(mask.sum())]
        assert counters["render.anchor_rows"] == [state.capacity]
        assert counters["render.instance_cap"][0] >= 1


@pytest.mark.parametrize("degree", [0, 1, 2, None])
def test_sh_colours_span_and_counters(degree):
    """SH colours: `render.sh` inside `render.bin`, the rows evaluated and
    the coefficients a row at the evaluated degree (None: the
    configuration's maximum, 2)."""
    cfg, state, mlps = _model(color_attr="SH2", view_dim=0)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            render(_cameras()[1], cfg, mlps, state, torch.zeros(3),
                   active_sh_degree=degree)
    snap = tracing.snapshot()
    sh = _by_name(snap)["render.sh"]
    assert [sp["parent"] for sp in sh] == ["render.bin"]
    assert sh[0]["host_ms"] > 0
    d = 2 if degree is None else degree
    assert snap["counters"]["render.sh_rows"] == [
        state.capacity * cfg.n_offsets]
    assert snap["counters"]["render.sh_coeffs"] == [(d + 1) ** 2]


def test_rgb_colours_record_no_sh():
    cfg, state, mlps = _model()
    with profile(activities=[ProfilerActivity.CPU]):
        _render_once(cfg, state, mlps, _cameras()[1])
    snap = tracing.snapshot()
    by = _by_name(snap)
    assert set(by) >= set(RENDER_SPANS) and "render.sh" not in by
    assert not {"render.sh_rows", "render.sh_coeffs"} & set(snap["counters"])


def test_viewer_poll_spans_share_the_frame(tmp_path):
    cfg, state, mlps = _model()
    cam = _cameras()[0]
    srv = ViewerServer("127.0.0.1", 0)
    client = socket.create_connection(("127.0.0.1", srv.bound_port))
    caps = {}
    try:
        client.sendall(frame_message(request_message(
            cam.viewmat.numpy(), cam.K.numpy(), W, H)))
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(50):
                srv.poll(lambda d: render_request(d, cfg, mlps, state,
                                                  torch.zeros(3), caps),
                         "verify")
                if srv.frames:
                    break
        got = b""
        want = W * H * 3 + 4 + len("verify")
        while len(got) < want:
            got += client.recv(want - len(got))
    finally:
        client.close()
        srv.close()
    assert got.endswith(b"verify")
    by = _by_name(tracing.snapshot())
    names = ("viewer.receive", "viewer.render", "viewer.quantize",
             "viewer.send")
    # one span each: the polls that timed out before the request came
    # recorded no receive
    for name in names:
        assert [(sp["request"], sp["parent"]) for sp in by[name]] == [
            (1, None)], name
    # the calibration's decode and the frame's, both under the render
    decodes = [sp["parent"] for sp in by["render.decode"]]
    assert len(decodes) >= 2 and set(decodes) == {"viewer.render"}
    for name in RENDER_SPANS:
        assert by[name][-1]["parent"] == "viewer.render"
    order = [sp["name"] for sp in tracing.snapshot()["spans"]
             if sp["name"] in names]
    assert order == list(names)


def test_profiler_started_inside_an_open_span():
    acts = [ProfilerActivity.CPU]
    with tracing.span("outer"):
        prof = profile(activities=acts)
        prof.start()
        with tracing.span("inner", request=7):
            torch.ones(2) + 1
    prof.stop()
    spans = tracing.snapshot()["spans"]
    assert [(s["name"], s["parent"], s["request"]) for s in spans] == [
        ("inner", None, 7)]
    assert tracing._open() == []


def test_profiler_stopped_inside_an_open_span():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with tracing.span("kept", request=1):
        pass
    with tracing.span("outer", request=2):
        with tracing.span("child"):
            pass
        prof.stop()
        with tracing.span("after"):
            pass
    spans = tracing.snapshot()["spans"]
    assert [(s["name"], s["parent"], s["request"]) for s in spans] == [
        ("kept", None, 1), ("child", "outer", 2)]
    assert tracing._open() == []
    assert not tracing.recording()


def test_span_records_an_exception_and_reraises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.span("fails"):
                raise ValueError("x")
    assert [s["name"] for s in tracing.snapshot()["spans"]] == ["fails"]
    assert tracing._open() == []


def test_the_cap_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing.RECORDER, "cap", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span("s", request=i):
                tracing.count("c", torch.tensor(i))
    snap = tracing.snapshot()
    assert [s["request"] for s in snap["spans"]] == [0, 1, 2]
    assert snap["counters"]["c"] == [0, 1, 2]
    # two spans and two counter values beyond the cap
    assert snap["counters"]["tracing.dropped"] == [4]
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "counters": {}}


def test_off_span_is_the_shared_no_op():
    assert tracing.span("a") is tracing.span("b", request=3)
    tracing.count("c", 1)
    assert tracing.snapshot() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("intervals, want", [
    ([(0.0, 4.0), (2.0, 6.0)], 6.0),                    # overlapping
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),      # nested
    ([(0.0, 1.0), (5.0, 7.0), (3.0, 4.0)], 4.0),        # disjoint
    ([(1.0, 2.0), (2.0, 3.0)], 2.0),                    # touching
    ([], 0.0),
])
def test_busy_union(intervals, want):
    assert busy_union(intervals) == pytest.approx(want)
