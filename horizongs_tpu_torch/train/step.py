"""The training step: render -> loss -> backward -> Adam -> statistics.

The JAX package's `train/step.py` in eager PyTorch: the forward render
(decode, projection, binning, K1 or for 2DGS K3), the loss, the backward
through autograd (K2 or K4 for the compositor), the Adam update with
per-group scheduled LRs, and the densification statistics
(`training_statis` of Horizon-GS) as masked dense updates. The
screen-space gradients the statistics need come from a zero probe added
to the projected means (`render(means2d_probe=...)`); for 2DGS it moves
the centre of the screen-space low-pass only (fields mx, my).

Parameters and moments are updated in place (see `optim.py`); the step
returns the same `TrainState` with the new statistics and step count.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.device import disable_tf32
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders
from horizongs_tpu_torch.render import render
from horizongs_tpu_torch.train.losses import assemble_loss, psnr
from horizongs_tpu_torch.train.optim import (
    AdamState,
    Groups,
    TrainableParams,
    adam_step,
    init_adam,
    lr_groups,
)
from horizongs_tpu_torch.train.schedules import expon_lr, group_lrs


class DensifyStats(NamedTuple):
    """Per-anchor / per-offset accumulators (`training_setup`)."""
    anchor_opacity_accum: torch.Tensor   # (C,)
    anchor_demon: torch.Tensor           # (C,) visit counts
    offset_gradient_accum: torch.Tensor  # (C*k,)
    offset_denom: torch.Tensor           # (C*k,)
    offset_opacity_accum: torch.Tensor   # (C*k,)
    max_radii2d: torch.Tensor            # (C*k,)


def init_stats(capacity: int, n_offsets: int,
               device: torch.device) -> DensifyStats:
    def z(n):
        return torch.zeros(n, dtype=torch.float32, device=device)
    ck = capacity * n_offsets
    return DensifyStats(z(capacity), z(capacity), z(ck), z(ck), z(ck), z(ck))


class TrainState(NamedTuple):
    params: TrainableParams
    rotation: torch.Tensor     # (C, 4): stored, not optimised
    level: torch.Tensor        # (C,) int32
    extra_level: torch.Tensor  # (C,)
    n: int                     # live anchors
    opt: AdamState
    stats: DensifyStats

    def anchor_state(self) -> AnchorState:
        p = self.params
        return AnchorState(anchor=p.anchor, offset=p.offset, feat=p.feat,
                           scaling_log=p.scaling_log, rotation=self.rotation,
                           level=self.level, extra_level=self.extra_level,
                           n=self.n)


def init_train_state(state: AnchorState, mlps: MlpDecoders) -> TrainState:
    """A fresh training state: the anchor tables as leaves that require
    grad (copies), the decoders as they are, zero moments and statistics."""
    params = TrainableParams(
        anchor=state.anchor.detach().clone().requires_grad_(True),
        offset=state.offset.detach().clone().requires_grad_(True),
        feat=state.feat.detach().clone().requires_grad_(True),
        scaling_log=state.scaling_log.detach().clone().requires_grad_(True),
        mlps=mlps)
    return TrainState(params=params, rotation=state.rotation,
                      level=state.level, extra_level=state.extra_level,
                      n=state.n, opt=init_adam(params),
                      stats=init_stats(state.capacity, state.n_offsets,
                                       state.anchor.device))


class CameraTensors(NamedTuple):
    """One training view: its camera and targets."""
    viewmat: torch.Tensor      # (4, 4)
    K: torch.Tensor            # (3, 3)
    cam_center: torch.Tensor   # (3,)
    uid: int
    image: torch.Tensor        # (H, W, 3) ground truth
    alpha_mask: torch.Tensor   # (H, W, 1)
    invdepth: torch.Tensor     # (H, W, 1) mono inverse depth (zeros if absent)
    depth_mask: torch.Tensor   # (H, W, 1)
    has_depth: float           # 0/1
    do_stats: float            # 0/1: accumulate densify statistics
    resolution_scale: float


def camera_tensors(cam: Camera, image: Optional[torch.Tensor] = None,
                   alpha_mask: Optional[torch.Tensor] = None,
                   invdepth: Optional[torch.Tensor] = None,
                   depth_mask: Optional[torch.Tensor] = None,
                   do_stats: bool = False) -> CameraTensors:
    """Absent targets become zeros (image, depth) or ones (alpha mask), as
    in the JAX package."""
    H, W, dev = cam.height, cam.width, cam.viewmat.device
    zero_img = torch.zeros((H, W, 1), dtype=torch.float32, device=dev)
    return CameraTensors(
        viewmat=cam.viewmat, K=cam.K, cam_center=cam.cam_center,
        uid=int(cam.uid),
        image=(image if image is not None
               else torch.zeros((H, W, 3), dtype=torch.float32, device=dev)),
        alpha_mask=(alpha_mask if alpha_mask is not None
                    else torch.ones((H, W, 1), dtype=torch.float32,
                                    device=dev)),
        invdepth=invdepth if invdepth is not None else zero_img,
        depth_mask=depth_mask if depth_mask is not None else zero_img,
        has_depth=1.0 if invdepth is not None else 0.0,
        do_stats=1.0 if do_stats else 0.0,
        resolution_scale=float(cam.resolution_scale))


@torch.no_grad()
def update_stats(opt, stats: DensifyStats, n_offsets: int,
                 opacities: torch.Tensor, selection_mask: torch.Tensor,
                 anchor_mask: torch.Tensor, radii: torch.Tensor,
                 means2d_grad: torch.Tensor, width: int, height: int,
                 gate: float) -> DensifyStats:
    """`training_statis` as dense masked updates; `gate` (0/1) says
    whether this view accumulates statistics."""
    C = stats.anchor_opacity_accum.shape[0]
    sel = selection_mask.float() * gate                        # (C*k,)
    vis = anchor_mask.float() * gate                           # (C,)
    op_ck = (opacities * sel).reshape(C, n_offsets)
    sel_ck = sel.reshape(C, n_offsets)
    zero = torch.zeros_like(stats.anchor_opacity_accum)

    if opt.pruning_type == "mean":
        s = torch.sum(op_ck, dim=1)
        cnt = torch.sum(sel_ck, dim=1)
        avg = torch.where(cnt > 0, s / torch.clamp_min(cnt, 1.0), zero)
        new_aopa = stats.anchor_opacity_accum + vis * avg
    elif opt.pruning_type == "max":
        s = torch.abs(torch.sum(op_ck, dim=1))
        new_aopa = torch.where(vis > 0,
                               torch.maximum(stats.anchor_opacity_accum, s),
                               stats.anchor_opacity_accum)
    else:
        raise ValueError(f"Unknown pruning_type: {opt.pruning_type}")
    new_demon = stats.anchor_demon + vis

    # per offset: selected and rendered (radius > 0)
    combined = sel * (radii > 0).float()                       # (C*k,)
    scale = torch.tensor([[width * 0.5, height * 0.5]],
                         dtype=torch.float32, device=means2d_grad.device)
    grad_norm = torch.linalg.norm(means2d_grad * scale, dim=-1)

    if opt.growing_type == "mean":
        new_ograd = stats.offset_gradient_accum + combined * grad_norm
        new_oopa = stats.offset_opacity_accum
        new_radii = stats.max_radii2d
    elif opt.growing_type == "max":
        hit = combined > 0
        new_ograd = torch.where(hit, torch.maximum(
            stats.offset_gradient_accum, torch.abs(grad_norm)),
            stats.offset_gradient_accum)
        new_radii = torch.where(hit, torch.maximum(stats.max_radii2d, radii),
                                stats.max_radii2d)
        new_oopa = stats.offset_opacity_accum + combined * opacities
    else:
        raise ValueError(f"Unknown growing_type: {opt.growing_type}")

    return DensifyStats(anchor_opacity_accum=new_aopa, anchor_demon=new_demon,
                        offset_gradient_accum=new_ograd,
                        offset_denom=stats.offset_denom + combined,
                        offset_opacity_accum=new_oopa, max_radii2d=new_radii)


class TrainStep:
    """`step(state, cam, iteration) -> (state, metrics)`; see
    `build_train_step`. The step is three stages, which a caller may also
    run one by one (to time them): `forward` (render and loss), `backward`
    (autograd, K2 or K4 for the compositor) and `update` (Adam, statistics,
    metrics)."""

    def __init__(self, cfg: ModelConfig, opt, height: int, width: int,
                 frozen_mlps: bool, add_prefilter: bool, rasterizer: str,
                 instance_cap: Optional[int]):
        if rasterizer not in ("cuda", "dense"):
            raise ValueError(f"Unknown rasterizer: {rasterizer}")
        self.cfg, self.opt = cfg, opt
        self.height, self.width = height, width
        self.frozen_mlps = frozen_mlps
        self.render_kw = dict(add_prefilter=add_prefilter,
                              rasterizer=rasterizer,
                              instance_cap=instance_cap)

    def forward(self, state: TrainState, cam: CameraTensors,
                iteration: float):
        """Render and loss with the graph kept: (loss, aux, pkg, probe)."""
        cfg, opt = self.cfg, self.opt
        p = state.params
        dev = p.anchor.device
        bg = torch.zeros(3, device=dev)
        probe = torch.zeros((p.offset.shape[0] * p.offset.shape[1], 2),
                            dtype=torch.float32, device=dev,
                            requires_grad=True)
        camera = Camera(viewmat=cam.viewmat, K=cam.K, width=self.width,
                        height=self.height, cam_center=cam.cam_center,
                        uid=cam.uid, resolution_scale=cam.resolution_scale)
        with torch.enable_grad():
            pkg = render(camera, cfg, p.mlps, state.anchor_state(), bg,
                         means2d_probe=probe, **self.render_kw)
            depth_w = expon_lr(iteration, opt.depth_l1_weight_init,
                               opt.depth_l1_weight_final,
                               max_steps=opt.iterations) * cam.has_depth
            loss, aux = assemble_loss(opt, pkg, cam.image, cam.alpha_mask,
                                      cam.invdepth, cam.depth_mask,
                                      iteration, depth_w, cfg.render_mode)
        return loss, aux, pkg, probe

    def backward(self, state: TrainState, loss: torch.Tensor,
                 probe: torch.Tensor):
        """(grads per group, probe gradient (C*k, 2)); a tensor the loss
        does not reach gets zeros."""
        groups = state.params.groups()
        leaves = [t for ts in groups.values() for t in ts] + [probe]
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = [torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, flat)]
        grads: Groups = {}
        i = 0
        for name, ts in groups.items():
            grads[name] = flat[i:i + len(ts)]
            i += len(ts)
        return grads, flat[-1]

    def update(self, state: TrainState, cam: CameraTensors,
               iteration: float, loss, aux, pkg, grads: Groups,
               probe_grad: torch.Tensor):
        """Adam (in place) and the statistics: (state, metrics)."""
        lrs = lr_groups(group_lrs(self.opt, iteration, 1.0),
                        frozen_mlps=self.frozen_mlps)
        new_opt = adam_step(state.params, grads, state.opt, lrs)
        new_stats = update_stats(
            self.opt, state.stats, self.cfg.n_offsets,
            pkg["opacity"].detach(), pkg["selection_mask"],
            pkg["visible_mask"], pkg["radii"], probe_grad, self.width,
            self.height, cam.do_stats)
        with torch.no_grad():
            metrics = {
                "loss": loss.detach(), "l1": aux["l1"].detach(),
                "ssim": aux["ssim"].detach(),
                "depth_l1": torch.as_tensor(aux["depth_l1"]).detach(),
                "psnr": psnr(pkg["render"] * cam.alpha_mask,
                             cam.image * cam.alpha_mask),
                "n_selected": torch.sum(pkg["selection_mask"]),
                "n_dropped": pkg["n_dropped"]}
        return state._replace(opt=new_opt, stats=new_stats), metrics

    def value_and_grad(self, state: TrainState, cam: CameraTensors,
                       iteration: float):
        """(loss, aux, pkg, grads per group, probe gradient (C*k, 2))."""
        loss, aux, pkg, probe = self.forward(state, cam, iteration)
        grads, probe_grad = self.backward(state, loss, probe)
        return loss.detach(), aux, pkg, grads, probe_grad

    def __call__(self, state: TrainState, cam: CameraTensors,
                 iteration: float):
        iteration = float(iteration)
        loss, aux, pkg, grads, probe_grad = self.value_and_grad(
            state, cam, iteration)
        return self.update(state, cam, iteration, loss, aux, pkg, grads,
                           probe_grad)


def build_train_step(cfg: ModelConfig, opt, height: int, width: int,
                     frozen_mlps: bool = False,
                     add_prefilter: bool = True,
                     rasterizer: str = "cuda",
                     instance_cap: Optional[int] = None) -> TrainStep:
    """The JAX package's `build_train_step`, eager: returns
    `step(state, cam: CameraTensors, iteration) -> (state, metrics)` with
    the metrics loss, l1, ssim, depth_l1, psnr, n_selected and n_dropped
    (tensors on the model's device). `rasterizer` is "cuda" (K1/K2, for
    2DGS K3/K4; their plain versions for CPU tensors) or "dense" (the
    oracle, through
    autograd). The background is black and the spatial LR scale 1.0, the
    JAX defaults. Turns TF32 off for the process (the SSIM
    convolutions)."""
    disable_tf32()
    return TrainStep(cfg, opt, height, width, frozen_mlps, add_prefilter,
                     rasterizer, instance_cap)
