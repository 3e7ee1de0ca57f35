"""The sharded training step: anchors split over "model", cameras over
"data", the compositing split into image bands.

The JAX package's `parallel/step.py` on `torch.distributed`, one process a
rank:

  * each rank holds a contiguous slice of the anchor table's rows (and
    their Adam moments and densification statistics); the MLP decode runs
    on those rows only. The decoders, the appearance table, `n` and Adam's
    step count are replicated;
  * the image's tile rows are split into n_model bands. Each rank projects
    its own gaussians, routes the compact splat records to the bands'
    ranks with an all_to_all (`parallel/tile_exchange.py`), then bins and
    composites only its band and halo rows either side of it, through the
    same kernels as a full view (K1/K2, for 2DGS K3/K4). A 2DGS band's
    composite starts on the view's tile grid (`band_halo`), so its tiles
    are the view's tiles. The band's loss terms are summed over "model"
    into the full-image loss
    (`train/losses.assemble_loss_band`), so no rank holds the full image;
  * data index d trains on camera d of the batch: gradients are the
    weighted mean over "data" (a view repeated k times to fill a batch
    carries loss weight 1/k), the decoders' and appearance table's also
    summed over "model"; the statistics' deltas are summed over "data"
    (the `max` types take the maximum).

`shard_tiles=False` is the replicated fallback (3DGS only): all_gather the
decoded gaussians over "model" and composite the full view on every rank.
It is the band path's oracle.

The gradient scale. In the band path each rank differentiates only its own
terms of the reduced loss (`collectives.all_reduce_sum` passes the
gradient through), and the reverse all_to_all brings each record's
gradient home, so the sum is the true gradient: no rescale, where the JAX
package divides by n_model (its psum's transpose is a psum). In the
fallback every rank differentiates the same full-image loss through the
all_gather, whose transpose sums the n_model equal cotangents: its
gradients are divided by n_model, as in the JAX package.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F

from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.device import disable_tf32
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.ops.binning import (
    count_tile_instances,
    ellipse_extents,
)
from horizongs_tpu_torch.ops.raster import _make_grid
from horizongs_tpu_torch.ops.raster_cuda import rasterize_cuda_3dgs
from horizongs_tpu_torch.ops.raster_fields import (
    backend_tile_shape,
    composite_fields_2dgs,
    composite_fields_3dgs,
    pack_fields_2dgs,
    pack_fields_3dgs,
    shift_band_3dgs,
)
from horizongs_tpu_torch.ops.reference import depth_to_normals
from horizongs_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    gather_rows,
    pmax,
    reduce_sum,
    trivial,
)
from horizongs_tpu_torch.parallel.mesh import Mesh
from horizongs_tpu_torch.parallel.tile_exchange import (
    band_layout,
    band_span,
    count_tile_row_loads,
    exchange_records,
)
from horizongs_tpu_torch.render import decode_view
from horizongs_tpu_torch.train.densify import TABLES
from horizongs_tpu_torch.train.losses import (
    assemble_loss,
    assemble_loss_band,
    psnr,
)
from horizongs_tpu_torch.train.optim import adam_step, lr_groups
from horizongs_tpu_torch.train.schedules import expon_lr, group_lrs
from horizongs_tpu_torch.train.step import (
    CameraTensors,
    DensifyStats,
    TrainState,
    update_stats,
)

# the SSIM window's radius: each band's loss needs this many rows of its
# neighbours on either side
HALO = 5


# ---------------------------------------------------------------------------
# the sharded state
# ---------------------------------------------------------------------------

def band_halo(gs_attr: str) -> int:
    """Rows composited on either side of a band. 3DGS: HALO, as in the JAX
    package (its binning is lossless, so a band's tile grid may be offset
    from the view's). 2DGS: HALO rounded up to the kernels' tile height,
    so the band's composite starts on the view's tile grid and each of its
    tiles is a tile of the view, with the same instances: the reference's
    2DGS binning is not lossless (ROADMAP §3), and a grid shifted by a
    part of a tile would bin other pixels to a surfel than the view's."""
    if gs_attr != "2D":
        return HALO
    _, tile_h = backend_tile_shape(gs_attr)
    return -(-HALO // tile_h) * tile_h


def _slice_rows(x: torch.Tensor, C: int, n_model: int, m: int):
    """Rows of model index m of a per-anchor (C rows) or per-offset
    (C*k rows) leaf."""
    per = x.shape[0] // C
    c = C // n_model
    return x[m * c * per:(m + 1) * c * per]


@torch.no_grad()
def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's state: its contiguous row slice of every per-anchor
    leaf (tables, rotation, levels, the tables' moments, statistics), and
    copies of the decoders and their moments; `n` and Adam's `t` stay the
    global ones. The capacity must divide the "model" axis."""
    n_model, m = mesh.shape["model"], mesh.m
    C = state.params.anchor.shape[0]
    if C % n_model:
        raise ValueError(f"capacity {C} does not divide model={n_model}: "
                         f"pad it first (train.densify.pad_state_capacity)")
    dev = mesh.device

    def rows(x):
        return _slice_rows(x, C, n_model, m).detach().to(dev, copy=True)

    p = state.params
    params = p._replace(**{t: rows(getattr(p, t)).requires_grad_(True)
                           for t in TABLES},
                        mlps=copy.deepcopy(p.mlps).to(dev))

    def moments(groups):
        return {g: [rows(ts[0])] if g in TABLES
                else [t.detach().to(dev, copy=True) for t in ts]
                for g, ts in groups.items()}

    return TrainState(
        params=params, rotation=rows(state.rotation),
        level=rows(state.level), extra_level=rows(state.extra_level),
        n=int(state.n),
        opt=state.opt._replace(mu=moments(state.opt.mu),
                               nu=moments(state.opt.nu)),
        stats=DensifyStats(*(rows(a) for a in state.stats)))


@torch.no_grad()
def unshard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole state on every rank of the "model" group (all_gather of
    each per-anchor leaf): the inverse of `shard_state`, for densify
    epochs, checkpoints, saves and evaluation."""
    g = mesh.group("model")
    p = state.params
    params = p._replace(
        **{t: gather_rows(getattr(p, t).detach(), g).requires_grad_(True)
           for t in TABLES},
        mlps=copy.deepcopy(p.mlps))

    def moments(groups):
        return {k: [gather_rows(ts[0], g)] if k in TABLES
                else [t.detach().clone() for t in ts]
                for k, ts in groups.items()}

    return TrainState(
        params=params, rotation=gather_rows(state.rotation, g),
        level=gather_rows(state.level, g),
        extra_level=gather_rows(state.extra_level, g), n=int(state.n),
        opt=state.opt._replace(mu=moments(state.opt.mu),
                               nu=moments(state.opt.nu)),
        stats=DensifyStats(*(gather_rows(a, g) for a in state.stats)))


def local_rows(state: TrainState, mesh: Mesh) -> int:
    """Live rows of this rank's slice: clip(n - m * C_local, 0, C_local)."""
    c = state.params.anchor.shape[0]
    return min(max(int(state.n) - mesh.m * c, 0), c)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _flat(grads: dict) -> torch.Tensor:
    """Gradient groups as one vector, for one collective."""
    return torch.cat([g.reshape(-1) for ts in grads.values() for g in ts])


def _unflat(v: torch.Tensor, grads: dict) -> dict:
    """`_flat`'s inverse, shaped like `grads`."""
    out, o = {}, 0
    for k, ts in grads.items():
        out[k] = []
        for g in ts:
            out[k].append(v[o:o + g.numel()].reshape(g.shape))
            o += g.numel()
    return out


class ShardedTrainStep:
    """`step(state, cams, iteration) -> (state, metrics)` on this rank's
    shard: `state` from `shard_state`, `cams` the batch's n_data
    `CameraTensors` (every rank gets the whole batch and trains on entry
    d). Like `train.step.TrainStep` it is three stages a caller may run one
    by one: `forward` (decode, exchange, composite, the reduced loss),
    `backward` (autograd through the kernels and collectives, then the
    gradients' reductions: the gradients Adam sees) and `update` (Adam and
    the statistics)."""

    def __init__(self, cfg: ModelConfig, opt, mesh: Mesh, height: int,
                 width: int, spatial_lr_scale: float, frozen_mlps: bool,
                 frozen_appearance: bool, add_prefilter: bool,
                 active_sh_degree: Optional[int],
                 background: Optional[torch.Tensor],
                 instance_cap: Optional[int], shard_tiles: bool,
                 band_cap: Optional[int], band_bounds):
        if cfg.gs_attr == "2D" and not shard_tiles:
            raise ValueError("2DGS requires shard_tiles=True in the sharded "
                             "step (the replicated fallback is 3DGS-only)")
        self.cfg, self.opt, self.mesh = cfg, opt, mesh
        self.height, self.width = height, width
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.frozen_mlps, self.frozen_appearance = (frozen_mlps,
                                                    frozen_appearance)
        self.add_prefilter = add_prefilter
        self.background = background
        self.instance_cap = instance_cap
        self.shard_tiles = shard_tiles
        self.band_cap = band_cap
        self.n_model = mesh.shape["model"]
        self.n_data = mesh.shape["data"]
        _, tile_h = backend_tile_shape(cfg.gs_attr)
        self.layout = band_layout(height, width, self.n_model, tile_h,
                                  bounds=band_bounds)
        self.halo = band_halo(cfg.gs_attr)
        self.sh_degree = cfg.max_sh_degree
        if self.sh_degree is not None and active_sh_degree is not None:
            self.sh_degree = active_sh_degree

    # -- the view --------------------------------------------------------
    def _cam(self, cams) -> CameraTensors:
        if isinstance(cams, CameraTensors):
            cams = [cams]
        if len(cams) != self.n_data:
            raise ValueError(f"{len(cams)} cameras for a batch of "
                             f"data={self.n_data}")
        return cams[self.mesh.d]

    def _weights(self, cams):
        if isinstance(cams, CameraTensors):
            cams = [cams]
        w = float(cams[self.mesh.d].loss_weight)
        return w, sum(float(c.loss_weight) for c in cams)

    def _decode(self, state: TrainState, cam: CameraTensors):
        p = state.params
        astate = AnchorState(
            anchor=p.anchor, offset=p.offset, feat=p.feat,
            scaling_log=p.scaling_log, rotation=state.rotation,
            level=state.level, extra_level=state.extra_level,
            n=local_rows(state, self.mesh))
        camera = Camera(viewmat=cam.viewmat, K=cam.K, width=self.width,
                        height=self.height, cam_center=cam.cam_center,
                        uid=cam.uid, resolution_scale=cam.resolution_scale)
        dec = decode_view(camera, self.cfg, p.mlps, astate,
                          self.add_prefilter)
        colors = dec.colors
        if self.cfg.color_attr != "RGB":
            colors = colors.reshape(-1, self.cfg.color_dim // 3, 3)
        return dec, colors, camera

    def _bg(self, dev):
        return (torch.zeros(3, device=dev) if self.background is None
                else self.background.to(dev))

    def _strip(self, x: torch.Tensor) -> torch.Tensor:
        """(H, W, C) -> this band's (Hp, W, C) rows with `halo` rows
        either side; rows outside the image are zeros (the padding the full
        image's SSIM window sees at its border)."""
        L, halo = self.layout, self.halo
        Hp = L.band_px + 2 * halo
        pad_bottom = max(L.starts_px[-1] + Hp - self.height - halo, 0)
        xp = F.pad(x, (0, 0, 0, 0, halo, pad_bottom))
        s = L.starts_px[self.mesh.m]
        return xp[s:s + Hp]

    # -- forward ----------------------------------------------------------
    def _band_loss(self, state, cam, probe, iteration):
        cfg, opt, L = self.cfg, self.opt, self.layout
        dec, colors, camera = self._decode(state, cam)
        K_local = dec.means.shape[0]
        send_cap = self.band_cap if self.band_cap is not None else K_local
        halo = self.halo
        dy0 = L.starts_px[self.mesh.m]
        h_band = L.heights_px[self.mesh.m]
        dy = float(dy0 - halo)
        Hp = L.band_px + 2 * halo
        args = (dec.means, dec.quats, dec.scales, dec.opacities, colors,
                camera.viewmat, camera.K, self.width, self.height)
        if cfg.gs_attr == "2D":
            fields, radii, depths, proj = pack_fields_2dgs(
                *args, sh_degree=self.sh_degree, means2d_probe=probe)
            records = torch.cat([fields, radii.detach()[:, None],
                                 depths.detach()[:, None]], dim=-1)
            ry = radii.detach()
            my = fields[:, 10].detach()
        else:
            fields, radii, proj = pack_fields_3dgs(
                *args, sh_degree=self.sh_degree, means2d_probe=probe)
            records = torch.cat([fields, radii.detach()[:, None]], dim=-1)
            _, e_ry, _ = ellipse_extents(proj.conics.detach(),
                                         dec.opacities.detach())
            ry = torch.where(radii > 0, e_ry, torch.zeros_like(e_ry))
            my = fields[:, 1].detach()
        recv, n_drop_exch = exchange_records(
            records, my, ry, radii.detach() > 0, L, send_cap,
            group=self.mesh.group("model"), halo_px=halo)

        bg = self._bg(fields.device)
        if cfg.gs_attr == "2D":
            # the view's coordinates, from the band's first row: a shifted
            # transform would round the intersection otherwise
            render_b, alphas_b, normals_b, distort_b, median_b, binfo = \
                composite_fields_2dgs(
                    recv[:, :18].contiguous(), recv[:, 18].detach(),
                    recv[:, 19].detach(), self.width, Hp, bg,
                    render_mode=cfg.render_mode, cap=self.instance_cap,
                    row0=dy0 - halo)
            extra = [normals_b, distort_b, median_b]
        else:
            render_b, alphas_b, binfo = composite_fields_3dgs(
                shift_band_3dgs(recv[:, :10], dy), recv[:, 10].detach(),
                self.width, Hp, bg, render_mode=cfg.render_mode,
                cap=self.instance_cap)
            extra = []

        dev = fields.device
        grow = dy0 - halo + torch.arange(Hp, device=dev)     # image rows
        row_ok = (grow >= 0) & (grow < self.height)
        li = torch.arange(Hp, device=dev)
        interior = (row_ok & (li >= halo) & (li < halo + h_band)
                    ).float()[:, None, None]
        # rows past the image bottom composite to background: zero them
        keep = row_ok.float()[:, None, None]
        render_p, alphas_p = render_b * keep, alphas_b * keep
        if render_p.shape[-1] == 4:
            image_p, depth_p = render_p[..., :3], render_p[..., 3:4]
        else:
            image_p, depth_p = render_p, None
        pkg = {"render": image_p, "render_depth": depth_p,
               "render_alphas": alphas_p}
        if cfg.gs_attr == "2D":
            normals_p, distort_p, median_p = (x * keep for x in extra)
            nfd = depth_to_normals(median_p[..., 0], camera.K, row0=dy)
            # the full view's differences leave the first and last image
            # rows' normals zero; the halo would give them a neighbour
            edge = (grow == 0) | (grow == self.height - 1)
            nfd = torch.where(edge[:, None, None], torch.zeros_like(nfd),
                              nfd)
            pkg.update(render_normals=normals_p,
                       render_normals_from_depth=nfd,
                       render_distort=distort_p)

        depth_w = expon_lr(iteration, opt.depth_l1_weight_init,
                           opt.depth_l1_weight_final,
                           max_steps=opt.iterations) * cam.has_depth
        contrib, const, sums = assemble_loss_band(
            opt, pkg, self._strip(cam.image), self._strip(cam.alpha_mask),
            self._strip(cam.invdepth), self._strip(cam.depth_mask),
            iteration, depth_w, cfg.render_mode, interior, self.height,
            self.width)
        # the scale regulariser: a masked mean over the selected gaussians
        # of every rank, its sums reduced with the loss terms
        sel = dec.selection_mask.float()
        prod = torch.prod(dec.scales, dim=-1) * sel
        zero = torch.zeros((), device=dev)
        pk = all_reduce_sum(torch.stack([
            contrib, torch.sum(prod), torch.sum(sel), sums["l1_sum"],
            sums["ssim_sum"], sums["mse_sum"],
            torch.as_tensor(sums["depth_sum"], device=dev) + zero]),
            self.mesh.group("model"))
        loss = const + pk[0]
        if getattr(opt, "lambda_dreg", 0.0) > 0:
            loss = loss + opt.lambda_dreg * pk[1] / torch.clamp_min(pk[2],
                                                                    1.0)
        D_c = float(self.height * self.width * 3)
        mse = pk[5].detach() / D_c
        aux = {"l1": pk[3].detach() / D_c, "ssim": pk[4].detach() / D_c,
               "depth_l1": pk[6].detach(), "total": loss.detach(),
               "psnr": 20.0 * torch.log10(
                   1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))}
        side = {"opacities": dec.opacities.detach(),
                "selection_mask": dec.selection_mask,
                "anchor_mask": dec.anchor_mask, "radii": proj.radii,
                "n_dropped_exchange": n_drop_exch,
                "n_dropped_instances": binfo["n_dropped"],
                "n_instances": binfo["n_instances"],
                "n_records": recv.shape[0],
                "records_local": (radii.detach() > 0).sum(),
                "records_received": (recv[:, 10 if cfg.gs_attr != "2D"
                                          else 18].detach() > 0).sum(),
                "local_stats": True}
        return loss, aux, side

    def _replicated_loss(self, state, cam, probe, iteration):
        cfg, opt = self.cfg, self.opt
        dec, colors, camera = self._decode(state, cam)
        g = self.mesh.group("model")
        means, quats, scales, opac, colors = (
            all_gather(x, g) for x in (dec.means, dec.quats, dec.scales,
                                       dec.opacities, colors))
        sel = gather_rows(dec.selection_mask.to(torch.uint8), g).bool()
        amask = gather_rows(dec.anchor_mask.to(torch.uint8), g).bool()
        render, alphas, info = rasterize_cuda_3dgs(
            means, quats, scales, opac, colors, camera.viewmat, camera.K,
            self.width, self.height, self._bg(means.device),
            sh_degree=self.sh_degree, render_mode=cfg.render_mode,
            cap=self.instance_cap, means2d_probe=probe)
        if render.shape[-1] == 4:
            image, depth = render[..., :3], render[..., 3:4]
        else:
            image, depth = render, None
        pkg = {"render": image, "render_depth": depth,
               "render_alphas": alphas, "scaling": scales, "opacity": opac,
               "selection_mask": sel}
        depth_w = expon_lr(iteration, opt.depth_l1_weight_init,
                           opt.depth_l1_weight_final,
                           max_steps=opt.iterations) * cam.has_depth
        loss, aux = assemble_loss(opt, pkg, cam.image, cam.alpha_mask,
                                  cam.invdepth, cam.depth_mask, iteration,
                                  depth_w, cfg.render_mode)
        aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}
        with torch.no_grad():
            aux["psnr"] = psnr(image * cam.alpha_mask,
                               cam.image * cam.alpha_mask)
        zero = torch.zeros((), dtype=torch.int32, device=means.device)
        side = {"opacities": opac.detach(), "selection_mask": sel,
                "anchor_mask": amask, "radii": info["radii"],
                "n_dropped_exchange": zero,
                "n_dropped_instances": info["n_dropped"],
                "n_instances": info["n_instances"],
                "n_records": means.shape[0], "local_stats": False}
        return loss, aux, side

    def forward(self, state: TrainState, cams, iteration: float):
        """Decode, exchange, composite and the reduced loss, with the graph
        kept: (loss, aux, side, probe). `side` carries what the statistics
        and the reductions need, and the counts (records received,
        instances, drops)."""
        cam = self._cam(cams)
        iteration = float(iteration)
        p = state.params
        rows = p.offset.shape[0] * p.offset.shape[1]
        if not self.shard_tiles:
            rows *= self.n_model
        probe = torch.zeros((rows, 2), dtype=torch.float32,
                            device=p.anchor.device, requires_grad=True)
        fn = self._band_loss if self.shard_tiles else self._replicated_loss
        with torch.enable_grad():
            loss, aux, side = fn(state, cam, probe, iteration)
        side["weights"] = self._weights(cams)
        return loss, aux, side, probe

    def backward(self, state: TrainState, loss: torch.Tensor,
                 probe: torch.Tensor, side: dict):
        """Autograd, then the reductions: (grads per group, probe gradient
        of this rank's rows), as Adam and the statistics see them."""
        groups = state.params.groups()
        leaves = [t for ts in groups.values() for t in ts] + [probe]
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = [torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, flat)]
        grads, i = {}, 0
        for name, ts in groups.items():
            grads[name] = flat[i:i + len(ts)]
            i += len(ts)
        probe_grad = flat[-1]
        if not side["local_stats"]:          # the fallback's full probe
            c = probe_grad.shape[0] // self.n_model
            probe_grad = probe_grad[self.mesh.m * c:(self.mesh.m + 1) * c]

        w, wsum = side["weights"]
        scale = w / wsum * (1.0 if self.shard_tiles else 1.0 / self.n_model)
        gd, gm = self.mesh.group("data"), self.mesh.group("model")
        if not trivial(gd):
            # one collective over "data": the weighted gradient mean and
            # the probe's plain mean
            n_g = sum(x.numel() for ts in grads.values() for x in ts)
            v = reduce_sum(torch.cat([_flat(grads) * scale,
                                      probe_grad.reshape(-1) / self.n_data]),
                           gd)
            grads = _unflat(v[:n_g], grads)
            probe_grad = v[n_g:].reshape(probe_grad.shape)
        elif scale != 1.0:
            grads = {k: [g * scale for g in ts] for k, ts in grads.items()}
        if not trivial(gm):
            # and one over "model": the decoders and the appearance table
            # saw only this rank's rows
            shared = {k: ts for k, ts in grads.items() if k not in TABLES}
            grads.update(_unflat(reduce_sum(_flat(shared), gm), shared))
        return grads, probe_grad

    def value_and_grad(self, state: TrainState, cams, iteration: float):
        """(loss, aux, side, reduced grads per group, probe gradient)."""
        loss, aux, side, probe = self.forward(state, cams, iteration)
        grads, probe_grad = self.backward(state, loss, probe, side)
        return loss.detach(), aux, side, grads, probe_grad

    def _reduce_stats(self, old_stats, local, gd):
        """The statistics' deltas summed over "data" (the `max` types take
        the maximum of the ranks' new values)."""
        opt = self.opt
        old = torch.cat([x.reshape(-1) for x in old_stats])
        new = torch.cat([x.reshape(-1) for x in local])
        adds = old + reduce_sum(new - old, gd)
        if opt.growing_type != "max" and opt.pruning_type != "max":
            sizes = [x.numel() for x in local]
            return DensifyStats(*(p.reshape(x.shape) for p, x in zip(
                adds.split(sizes), local)))
        maxes = pmax(new, gd)
        parts = []
        o = 0
        for name, x in zip(DensifyStats._fields, local):
            use_max = ((name == "anchor_opacity_accum"
                        and opt.pruning_type == "max")
                       or (name in ("offset_gradient_accum", "max_radii2d")
                           and opt.growing_type == "max"))
            src = maxes if use_max else adds
            parts.append(src[o:o + x.numel()].reshape(x.shape))
            o += x.numel()
        return DensifyStats(*parts)

    def update(self, state: TrainState, cams, iteration: float, loss, aux,
               side: dict, grads: dict, probe_grad: torch.Tensor):
        """Adam (in place) and the statistics: (state, metrics)."""
        iteration = float(iteration)
        cam = self._cam(cams)
        lrs = lr_groups(group_lrs(self.opt, iteration, self.spatial_lr_scale),
                        frozen_mlps=self.frozen_mlps,
                        frozen_appearance=self.frozen_appearance)
        new_opt = adam_step(state.params, grads, state.opt, lrs)

        k = self.cfg.n_offsets
        opac, sel = side["opacities"], side["selection_mask"]
        amask, radii = side["anchor_mask"], side["radii"]
        if not side["local_stats"]:
            c = state.params.anchor.shape[0]
            lo, hi = self.mesh.m * c, (self.mesh.m + 1) * c
            opac, sel, radii = (x[lo * k:hi * k] for x in (opac, sel, radii))
            amask = amask[lo:hi]
        local = update_stats(self.opt, state.stats, k, opac, sel, amask,
                             radii, probe_grad, self.width, self.height,
                             cam.do_stats)
        gd = self.mesh.group("data")
        with torch.no_grad():
            if trivial(gd):             # one view: its own statistics
                stats = local
            else:
                stats = self._reduce_stats(state.stats, local, gd)

            w, wsum = side["weights"]
            dev = loss.device
            mv = reduce_sum(torch.stack([
                loss.detach() * (w / wsum), aux["l1"] / self.n_data,
                aux["ssim"] / self.n_data, aux["psnr"] / self.n_data,
                torch.as_tensor(aux["depth_l1"], device=dev) / self.n_data
            ]).float(), gd)
            drops = torch.stack([
                torch.as_tensor(side["n_dropped_exchange"], device=dev),
                torch.as_tensor(side["n_dropped_instances"], device=dev)
            ]).to(torch.int32)
            drops = pmax(pmax(drops, gd), self.mesh.group("model"))
        metrics = {"loss": mv[0], "l1": mv[1], "ssim": mv[2], "psnr": mv[3],
                   "depth_l1": mv[4], "n_dropped": drops.sum(),
                   "n_dropped_exchange": drops[0],
                   "n_dropped_instances": drops[1]}
        return state._replace(opt=new_opt, stats=stats), metrics

    def __call__(self, state: TrainState, cams, iteration: float):
        iteration = float(iteration)
        loss, aux, side, grads, probe_grad = self.value_and_grad(
            state, cams, iteration)
        return self.update(state, cams, iteration, loss, aux, side, grads,
                           probe_grad)


def build_sharded_train_step(cfg: ModelConfig, opt, mesh: Mesh, height: int,
                             width: int, spatial_lr_scale: float = 1.0,
                             frozen_mlps: bool = False,
                             frozen_appearance: bool = False,
                             add_prefilter: bool = True,
                             active_sh_degree: Optional[int] = None,
                             background: Optional[torch.Tensor] = None,
                             instance_cap: Optional[int] = None,
                             shard_tiles: bool = True,
                             band_cap: Optional[int] = None,
                             band_bounds=None) -> ShardedTrainStep:
    """The JAX package's `build_sharded_train_step`, eager, one rank of
    it: returns `step(state, cams, iteration) -> (state, metrics)`, the
    metrics loss, l1, ssim, psnr and depth_l1 (reduced over "data"), and
    n_dropped = n_dropped_exchange + n_dropped_instances (the maxima over
    the mesh). `instance_cap` is the per-band tile-instance capacity,
    `band_cap` the record slots of each (source, band) pair (default:
    every local record, which never drops); `band_bounds` band boundaries
    in tile rows (`tile_exchange.suggest_band_bounds`), uniform by
    default. Overflows are counted, never silent. The compositing goes
    through K1/K2 (K3/K4 for 2DGS), their plain versions on CPU tensors.
    Turns TF32 off for the process."""
    disable_tf32()
    return ShardedTrainStep(cfg, opt, mesh, height, width, spatial_lr_scale,
                            frozen_mlps, frozen_appearance, add_prefilter,
                            active_sh_degree, background, instance_cap,
                            shard_tiles, band_cap, band_bounds)


# ---------------------------------------------------------------------------
# band_cap and band bound calibration: the routing the step will do
# ---------------------------------------------------------------------------

@torch.no_grad()
def _routing_inputs(cam: Camera, cfg: ModelConfig, mlps, state: AnchorState,
                    add_prefilter: bool):
    """(fields, radii, my, ry, valid) of every decoded row of the whole
    table: the same decode -> pack path as the band step."""
    dec = decode_view(cam, cfg, mlps, state, add_prefilter)
    colors = dec.colors
    if cfg.color_attr != "RGB":
        colors = colors.reshape(-1, cfg.color_dim // 3, 3)
    args = (dec.means, dec.quats, dec.scales, dec.opacities, colors,
            cam.viewmat, cam.K, cam.width, cam.height)
    if cfg.gs_attr == "2D":
        fields, radii, _, _ = pack_fields_2dgs(*args)
        return fields, radii, fields[:, 10], radii, radii > 0
    fields, radii, proj = pack_fields_3dgs(*args)
    _, e_ry, _ = ellipse_extents(proj.conics, dec.opacities)
    return (fields, radii, fields[:, 1],
            torch.where(radii > 0, e_ry, torch.zeros_like(e_ry)), radii > 0)


@torch.no_grad()
def count_band_matrix(cam: Camera, cfg: ModelConfig, mlps,
                      state: AnchorState, n_model: int,
                      add_prefilter: bool = True,
                      band_bounds=None) -> torch.Tensor:
    """The (source rank, band) matrix of records routed for this view,
    from the whole table split into the n_model row slices the mesh uses.
    Its largest element is what `band_cap` must cover; its column sums are
    each band's compositing load, whose spread is the imbalance the step
    waits on."""
    _, tile_h = backend_tile_shape(cfg.gs_attr)
    layout = band_layout(cam.height, cam.width, n_model, tile_h,
                         bounds=band_bounds)
    _, _, my, ry, valid = _routing_inputs(cam, cfg, mlps, state,
                                          add_prefilter)
    b0, b1 = band_span(my, ry, layout, halo_px=band_halo(cfg.gs_attr))
    dests = torch.arange(n_model, dtype=torch.int32, device=my.device)[:, None]
    touch = valid[None, :] & (b0[None, :] <= dests) & (dests <= b1[None, :])
    K = touch.shape[1]
    if K % n_model:
        raise ValueError(
            f"decoded row count {K} is not divisible by n_model={n_model}: "
            f"pad the anchor table first (train.densify.pad_state_capacity)")
    return touch.reshape(n_model, n_model, K // n_model).sum(-1).T


def count_band_records(cam: Camera, cfg: ModelConfig, mlps,
                       state: AnchorState, n_model: int,
                       add_prefilter: bool = True, band_bounds=None) -> int:
    """The most records one (source rank, band) pair carries for this
    view; feed the maximum over sample views to
    `tile_exchange.suggest_band_cap`."""
    return int(count_band_matrix(cam, cfg, mlps, state, n_model,
                                 add_prefilter, band_bounds).max())


@torch.no_grad()
def count_band_instances(cam: Camera, cfg: ModelConfig, mlps,
                         state: AnchorState, n_model: int,
                         add_prefilter: bool = True,
                         band_bounds=None) -> list:
    """Each band's tile-instance count for this view: the records routed
    to it, binned over its rows and halo rows as the band step bins them.
    The most over the bands and sample views is what the step's
    `instance_cap` must cover (a band's count is not the view's / n_model:
    the bands differ, and records near a boundary go to both)."""
    tile_w, tile_h = backend_tile_shape(cfg.gs_attr)
    layout = band_layout(cam.height, cam.width, n_model, tile_h,
                         bounds=band_bounds)
    halo = band_halo(cfg.gs_attr)
    grid = _make_grid(cam.width, layout.band_px + 2 * halo, tile_w, tile_h)
    fields, radii, my, ry, valid = _routing_inputs(cam, cfg, mlps, state,
                                                   add_prefilter)
    b0, b1 = band_span(my, ry, layout, halo_px=halo)
    counts = []
    for m in range(n_model):
        r = torch.where(valid & (b0 <= m) & (m <= b1), radii,
                        torch.zeros_like(radii))
        dy = float(layout.starts_px[m] - halo)
        if cfg.gs_attr == "2D":
            xy, conics, opac = fields[:, 9:11], None, None
        else:
            xy, conics, opac = fields[:, 0:2], fields[:, 2:5], fields[:, 5]
        xy = torch.stack([xy[:, 0], xy[:, 1] - dy], dim=1)
        counts.append(int(count_tile_instances(
            xy, r, grid.n_tiles_x, grid.n_tiles_y, tile_w, tile_h,
            conics=conics, opacities=opac)))
    return counts


def count_view_row_loads(cam: Camera, cfg: ModelConfig, mlps,
                         state: AnchorState,
                         add_prefilter: bool = True) -> torch.Tensor:
    """Per-tile-row record loads of this view; feed their sum over sample
    views to `tile_exchange.suggest_band_bounds`."""
    _, tile_h = backend_tile_shape(cfg.gs_attr)
    _, _, my, ry, valid = _routing_inputs(cam, cfg, mlps, state,
                                          add_prefilter)
    return count_tile_row_loads(my, ry, valid, -(-cam.height // tile_h),
                                tile_h)

