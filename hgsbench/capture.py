"""What the benchmark observes of the program's calls, from outside it:
which of the benchmark's views the trainer fed to its step, the state
around its first densify epoch (copied to host memory), and the
compositors' arguments of the first calls of a traced stretch (kept by
reference, not copied, so the trace sees no extra work). The wrappers are
installed for the duration of a `with` and taken off after it.
"""
from __future__ import annotations

import contextlib
import time

import torch

from hgsbench import counts
from hgsbench.reference import check
from hgsbench.reference.render import prefilter_anchors
from hgsbench.reference.anchors import anchor_lod_mask
from hgsbench.reference.cameras import Camera


@contextlib.contextmanager
def step_picks(trainer, picks: list):
    """Append (iteration, view index) of every step the trainer takes; under
    a mesh, (iteration, [(view index, loss weight), ...]) of its batch."""
    orig = trainer._step_fn

    def step_fn(H, W):
        step = orig(H, W)

        def call(state, ct, it):
            if isinstance(ct, list):
                picks.append((int(it), [(int(c.uid), float(c.loss_weight))
                                        for c in ct]))
            else:
                picks.append((int(it), int(ct.uid)))
            return step(state, ct, it)
        return call
    trainer._step_fn = step_fn
    try:
        yield
    finally:
        del trainer._step_fn


STATS = ("anchor_opacity_accum", "anchor_demon", "offset_gradient_accum",
         "offset_denom", "offset_opacity_accum", "max_radii2d")


def _tables(state, rows: int) -> dict:
    p = state.params
    return {"anchor": p.anchor[:rows], "offset": p.offset[:rows],
            "feat": p.feat[:rows], "scaling_log": p.scaling_log[:rows],
            "level": state.level[:rows],
            "extra_level": state.extra_level[:rows]}


def _epoch_inputs(state) -> dict:
    out = {k: getattr(state.stats, k) for k in STATS}
    out.update(_tables(state, state.params.anchor.shape[0]))
    return out


def epoch_buffers(state) -> dict:
    """Host buffers (pinned on a card) for `first_epoch`, shaped after the
    trainer's state: its statistics and tables, and the tables after an
    epoch that grows the capacity by up to an eighth (a larger one is
    copied without them)."""
    pin = state.params.anchor.device.type == "cuda"
    rows = state.params.anchor.shape[0] * 9 // 8

    def like(t, n=None):
        shape = (t.shape[0] if n is None else n,) + tuple(t.shape[1:])
        return torch.empty(shape, dtype=t.dtype, pin_memory=pin)
    return {"before": {k: like(t) for k, t in _epoch_inputs(state).items()},
            "after": {k: like(t, rows) for k, t in _tables(state, 1).items()}}


def _copy(src: dict, bufs: dict) -> dict:
    """Host copies of `src`, into `bufs` where they fit (without waiting
    for the device: the copies are in stream order, and the caller syncs
    before reading them)."""
    out = {}
    for k, t in src.items():
        b = bufs[k]
        if t.shape[0] <= b.shape[0]:
            out[k] = b[:t.shape[0]]
            out[k].copy_(t.detach(), non_blocking=True)
        else:
            out[k] = t.detach().to("cpu", copy=True)
    return out


@contextlib.contextmanager
def first_epoch(snap: dict, bufs: dict):
    """Copy to host memory (`bufs`, from `epoch_buffers`) the state that
    the trainer's first densify epoch is handed (the statistics and the
    tables its decision reads) into `snap["before"]`, the tables it leaves
    into `snap["after"]`, and the epoch's arguments; later epochs are left
    alone. The copies are complete once the device has been synced."""
    from horizongs_tpu_torch.train import trainer as trainer_mod
    orig = trainer_mod.run_densify

    def run_densify(cfg, opt, state, iteration, **kw):
        if snap:
            return orig(cfg, opt, state, iteration, **kw)
        t0 = time.perf_counter()
        before = _copy(_epoch_inputs(state), bufs["before"])
        before["n"] = int(state.n)
        t1 = time.perf_counter()
        out = orig(cfg, opt, state, iteration, **kw)
        t2 = time.perf_counter()
        after = _copy(_tables(out, int(out.n)), bufs["after"])
        after["n"] = int(out.n)
        snap.update(before=before, after=after, iteration=iteration,
                    stage=kw.get("stage", "coarse"),
                    cam_infos=kw.get("cam_infos"),
                    weed_ratio=kw.get("weed_ratio", 0.0),
                    copy_s=(t1 - t0) + (time.perf_counter() - t2))
        return out
    trainer_mod.run_densify = run_densify
    try:
        yield
    finally:
        trainer_mod.run_densify = orig


@contextlib.contextmanager
def compositor_calls(trainer, calls: list, n: int):
    """Keep the forward compositor's arguments and the view of the first
    `n` steps taken while the trainer's profiler runs."""
    from horizongs_tpu_torch.ops import raster_cuda
    names = ("rasterize_fwd", "rasterize2d_fwd")
    orig = {k: getattr(raster_cuda, k) for k in names}
    picks = []

    def wrap(name):
        def fwd(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y, *a):
            if trainer._profiler is not None and len(calls) < n:
                view = picks[-1][1]
                if isinstance(view, list):      # this rank's view of a batch
                    view = view[trainer.mesh.d][0]
                calls.append({"kind": "3d" if name == names[0] else "2d",
                              "args": (fields, gauss_id, tile_starts,
                                       n_tiles_x),
                              "view": view,
                              "iteration": picks[-1][0],
                              "sh_degree": trainer.active_sh_degree})
            return orig[name](fields, gauss_id, tile_starts, n_tiles_x,
                              n_tiles_y, *a)
        return fwd
    for k in names:
        setattr(raster_cuda, k, wrap(k))
    try:
        with step_picks(trainer, picks):
            yield
    finally:
        for k in names:
            setattr(raster_cuda, k, orig[k])


@contextlib.contextmanager
def render_calls(calls: list, n: int, active: list):
    """The viewer's counterpart of `compositor_calls`: keep the forward
    compositor's arguments of the first `n` calls made while `active[0]`
    is true, with `active[1]` (the request's camera) beside them."""
    from horizongs_tpu_torch.ops import raster_cuda
    orig = raster_cuda.rasterize_fwd

    def fwd(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y, *a):
        if active[0] and len(calls) < n:
            calls.append({"kind": "3d",
                          "args": (fields, gauss_id, tile_starts, n_tiles_x),
                          "camera": active[1]})
        return orig(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y, *a)
    raster_cuda.rasterize_fwd = fwd
    try:
        yield
    finally:
        raster_cuda.rasterize_fwd = orig


@torch.no_grad()
def visible_anchors(cfg: dict, tables, cam: Camera, device) -> int:
    """Anchors the view's LOD mask and frustum prefilter select, by the
    reference's copies of both, on the benchmark's table."""
    mcfg = check.model_config(cfg)
    state = check.state_of(tables, device)
    mask, _ = anchor_lod_mask(mcfg, state, cam.cam_center,
                              cam.resolution_scale)
    if cfg["yaml"]["pipeline_params"].get("add_prefilter", True):
        mask = prefilter_anchors(mcfg, state, cam, mask)
    return int(mask.sum())


def count_calls(calls: list, cfg: dict, tables, views, device) -> list:
    """Each kept call's walked pairs (`counts.count_pairs`) and its view's
    visible anchors (counted on the benchmark's initial table); the
    arguments are let go."""
    out = []
    for c in calls:
        fields, gauss_id, tile_starts, ntx = c.pop("args")
        c["pairs"] = counts.count_pairs(c["kind"], fields, gauss_id,
                                        tile_starts, ntx)
        del fields, gauss_id, tile_starts
        if "camera" in c:
            cam = c.pop("camera")
        else:
            v = c["view"]
            cam = Camera(viewmat=views.viewmat[v], K=views.K[v],
                         width=views.width, height=views.height,
                         cam_center=views.center[v])
        c["visible"] = visible_anchors(cfg, tables, cam, device)
        out.append(c)
    return out
