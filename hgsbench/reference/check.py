"""The plain reference's runs, from the benchmark's own inputs.

Everything here is plain PyTorch from this folder (frozen copies of the
program's plain path, with the CUDA compositors replaced by their plain
versions); it imports neither the program nor JAX. It is handed the
benchmark's tables and views, never anything the program made: the
training views that the program's trainer drew are named by their index
into the benchmark's views, and the viewer's cameras are parsed from the
requests as sent.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from hgsbench.reference import step as ref_step
from hgsbench.reference.anchors import AnchorState
from hgsbench.reference.cameras import Camera
from hgsbench.reference.config import ModelConfig
from hgsbench.reference.mlp import MlpDecoders, TwoLayerMLP
from hgsbench.reference.render import render

LEAF_SUFFIXES = ("w1", "b1", "w2", "b2")


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig.from_dict(cfg["yaml"]["model_params"]["model_config"])


def optim(cfg: dict) -> SimpleNamespace:
    """The configuration's optim_params as published (the file carries
    every key the step reads)."""
    return SimpleNamespace(**cfg["yaml"]["optim_params"])


def state_of(tables, device) -> AnchorState:
    return AnchorState(*(t.to(device) for t in tables[:7]), n=tables.n)


def decoders_of(tables, device) -> MlpDecoders:
    def mlp(name, tanh=False):
        return TwoLayerMLP(*(t.to(device).clone() for t in tables.mlp[name]),
                           final_tanh=tanh)
    return MlpDecoders(mlp("opacity", True), mlp("cov"), mlp("color"))


def leaf_names(groups: dict) -> list:
    """Names of the optimised tensors in `groups()` order: the four tables,
    then each MLP's w1, b1, w2, b2."""
    names = []
    for g, ts in groups.items():
        if len(ts) == 1:
            names.append(g)
        else:
            names.extend(f"{g}.{s}" for s in LEAF_SUFFIXES[:len(ts)])
    return names


def leaves(groups: dict) -> list:
    return [t for ts in groups.values() for t in ts]


def stats_gate(cfg: dict, it: int, aerial: bool) -> bool:
    """Whether a view accumulates densify statistics at iteration `it`
    (the trainer's rule: inside (start_stat, update_until), for the view
    types the pipeline densifies)."""
    op, pp = cfg["yaml"]["optim_params"], cfg["yaml"]["pipeline_params"]
    inside = op["start_stat"] < it < op["update_until"]
    return inside and ((aerial and pp["aerial_densify"])
                       or (not aerial and pp["street_densify"]))


def train_steps(cfg: dict, tables, views, picks, extent: float, device,
                tf32: bool = False) -> dict:
    """Run the reference's training step over `picks` ((iteration, view
    index) in order) from the benchmark's initial tables. Returns the loss
    of each step, the norm of each leaf's gradient at the first step, the
    norm of each leaf's change over all of them, the norm of each densify
    statistic after them, and the leaf names.
    `tf32` computes the matmuls and convolutions in TF32 (the control)."""
    mcfg, op = model_config(cfg), optim(cfg)
    ts = ref_step.init_train_state(state_of(tables, device),
                                   decoders_of(tables, device))
    start = [t.detach().clone() for t in leaves(ts.params.groups())]
    step = ref_step.build_train_step(
        mcfg, op, views.height, views.width, spatial_lr_scale=extent,
        background=torch.zeros(3, device=device))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    losses, grad_norms = [], None
    try:
        for it, v in picks:
            cam = Camera(viewmat=views.viewmat[v], K=views.K[v],
                         width=views.width, height=views.height,
                         cam_center=views.center[v], uid=v)
            ct = ref_step.camera_tensors(
                cam, image=views.image[v], alpha_mask=views.alpha_mask[v],
                invdepth=views.invdepth[v], depth_mask=views.depth_mask[v],
                do_stats=stats_gate(cfg, it, views.is_aerial[v]))
            loss, aux, pkg, grads, probe_grad = step.value_and_grad(
                ts, ct, float(it))
            if int(pkg["n_dropped"]) != 0:
                raise RuntimeError("the reference dropped tile instances")
            if grad_norms is None:
                grad_norms = [float(torch.linalg.norm(g.double()))
                              for gs in grads.values() for g in gs]
            ts, _ = step.update(ts, ct, float(it), loss, aux, pkg, grads,
                                probe_grad)
            losses.append(float(loss))
            del aux, pkg, grads, probe_grad
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        change = [float(torch.linalg.norm((a.detach() - b).double()))
                  for a, b in zip(leaves(ts.params.groups()), start)]
        stats = {k: float(torch.linalg.norm(v.double()))
                 for k, v in ts.stats._asdict().items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "stat_norms": stats,
            "names": leaf_names(ts.params.groups())}


@torch.no_grad()
def render_frames(cfg: dict, tables, cams: list, device,
                  tf32: bool = False) -> list:
    """The (H, W, 3) uint8 frames of the viewer's requests (cams: parsed
    requests, `hgsbench.wire.parse_request`), rendered by the reference
    and quantized as the viewer quantizes them."""
    from hgsbench.wire import quantize
    mcfg = model_config(cfg)
    state, mlps = state_of(tables, device), decoders_of(tables, device)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    out = []
    try:
        for d in cams:
            viewmat = np.ascontiguousarray(d["viewmat"])
            center = np.linalg.inv(viewmat)[:3, 3].astype(np.float32)
            cam = Camera(viewmat=torch.from_numpy(viewmat).to(device),
                         K=torch.from_numpy(d["K"]).to(device),
                         width=d["width"], height=d["height"],
                         cam_center=torch.from_numpy(center).to(device))
            pkg = render(cam, mcfg, mlps, state,
                         torch.zeros(3, device=device))
            if int(pkg["n_dropped"]) != 0:
                raise RuntimeError("the reference dropped tile instances")
            out.append(quantize(pkg["render"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return out
