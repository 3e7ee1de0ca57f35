"""Densification: gradient-driven anchor growing and opacity pruning.

The JAX package's `train/densify.py`: one grow+prune epoch over the
capacity-padded training state, run every `update_interval` iterations,
in place of the reference's in-place optimizer surgery
(`basic_model.py:212-295`, `base_model.py:393-465`,
`lod_model.py:466-596`). The semantics are the JAX package's:
  * growing_type mean: grads = accum/denom; max: grads = accum scaled by
    max_radii2d * opacity^(1/5), gated by opacity > 0.15
  * flat model: `update_depth` rounds of coarser voxel grids with
    threshold x (update_hierachy_factor//2)^i and random decimation
  * LOD model: per-level thresholds x fork^(update_ratio*level),
    extra_level promotion (extra_ratio/extra_up), the fine stage adds at
    max(level+1, aerial_levels), weed-out of candidates
  * voxel dedup with feature inheritance by per-voxel max
  * pruning restricted by stage to aerial/street levels (LOD)
  * Adam moments: pruned rows dropped, new rows start at zero
  * scaling clamp on prune: scaling_log[:, 3:] capped at 0.05
    (`basic_model.py:162-166`)

Where the work runs: the decision arrays (grads_norm, offset_mask), the
candidate rows' xyz and feat, and the repack (gather the kept rows,
scatter the new ones, the resets and the clamp) are torch ops on the
state's device; only the decision arrays, the anchors' positions, levels
and opacity statistics and the candidates' rows cross to the host, where
the grow/prune decision runs in numpy, the JAX package's code in its
order (the same `np.random.Generator` seed gives the same flat-model
decimation). The JAX package's jit caches and its multi-host gather have
no counterpart here.

Port-specific: the new state's anchor tables are fresh leaves that require
grad (Adam updates the state's leaves in place, `optim.py`); the Adam
moments of the four table groups are gathered and scattered row for row,
the MLP and appearance moments and the step count stay as they are (the
decoders and their moments are copied, so that training the new state
leaves the input state as it was). After
an epoch that changed the table, the caller recalibrates the instance cap
(`raster_cuda.suggest_instance_cap`), since the decoded count changed; an
epoch that grows past the capacity takes `round_capacity(n_new,
capacity_block)` rows.
"""
from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch

from horizongs_tpu_torch.models.anchors import round_capacity, weed_out_mask
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.train.optim import AdamState, TrainableParams
from horizongs_tpu_torch.train.step import DensifyStats, TrainState, init_stats

TABLES = ("anchor", "offset", "feat", "scaling_log")


def _scatter_max_by_group(values: np.ndarray, groups: np.ndarray,
                          n_groups: int) -> np.ndarray:
    """Per-group elementwise max (torch_scatter.scatter_max, the feature
    inheritance of `base_model.py:439`)."""
    out = np.full((n_groups,) + values.shape[1:], -np.inf, dtype=values.dtype)
    np.maximum.at(out, groups, values)
    out[~np.isfinite(out)] = 0.0
    return out


def _rows_as_void(a: np.ndarray) -> np.ndarray:
    """(N, 3) int64 rows -> (N,) void keys (byte-wise row equality)."""
    a = np.ascontiguousarray(a)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1])))[:, 0]


def _dedup_against(existing: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """True for candidate grid coords already present in `existing`
    (`get_remove_duplicates`, `basic_model.py:179-190`): sort-based
    membership on packed row keys, O((E+C) log(E+C))."""
    if existing.shape[0] == 0 or candidates.shape[0] == 0:
        return np.zeros(candidates.shape[0], dtype=bool)
    return np.isin(_rows_as_void(candidates), _rows_as_void(existing))


def _grow_flat(cfg: ModelConfig, opt, grow: dict, grads_norm: np.ndarray,
               offset_mask: np.ndarray, rng: np.random.Generator,
               voxel_size: float):
    """Flat-model growth (`base_model.py:393-465`) on the small host
    arrays of `grow` (anchors and levels of every row, xyz and feat of the
    candidate rows `sel_idx`); appends candidate rows to grow["new_*"]."""
    sel_idx = grow["sel_idx"]
    for i in range(cfg.update_depth):
        cur_threshold = opt.densify_grad_threshold * (
            (cfg.update_hierachy_factor // 2) ** i)
        cand_sel = ((grads_norm[sel_idx] >= cur_threshold)
                    & offset_mask[sel_idx])
        cand_sel &= rng.random(sel_idx.shape[0]) > (0.5 ** (i + 1))

        size_factor = cfg.update_init_factor // (cfg.update_hierachy_factor ** i)
        cur_size = voxel_size * size_factor

        grid_coords = np.round(grow["anchor"] / cur_size
                               - cfg.padding).astype(np.int64)
        sel_xyz = grow["xyz_sel"][cand_sel]
        sel_coords = np.round(sel_xyz / cur_size - cfg.padding).astype(np.int64)
        uniq, inverse = np.unique(sel_coords, axis=0, return_inverse=True)
        if getattr(opt, "overlap", False):
            keep_new = np.ones(uniq.shape[0], dtype=bool)
        else:
            keep_new = ~_dedup_against(grid_coords, uniq)
        cand_anchor = (uniq[keep_new].astype(np.float32) * cur_size
                       + cfg.padding * cur_size)
        if cand_anchor.shape[0] == 0:
            continue
        feat_rep = grow["feat_sel"][cand_sel]
        new_feat = _scatter_max_by_group(feat_rep, inverse,
                                         uniq.shape[0])[keep_new]
        _append_rows(grow, cand_anchor, new_feat,
                     np.log(np.full((cand_anchor.shape[0], 6), cur_size,
                                    dtype=np.float32)),
                     np.zeros(cand_anchor.shape[0], dtype=np.int32))


def _grow_lod(cfg: ModelConfig, opt, grow: dict, grads_norm: np.ndarray,
              offset_mask: np.ndarray, stage: str,
              cam_infos: Optional[np.ndarray], weed_ratio: float):
    """LOD growth (`lod_model.py:487-596`) on the small `grow` arrays (see
    `_grow_flat`); dedup runs against the anchors, rows appended by earlier
    levels of this epoch included."""
    k = cfg.n_offsets
    init_count = grow["init_count"]
    sel_idx = grow["sel_idx"]
    grads = grads_norm.copy()
    grads[~offset_mask] = 0.0
    anchor_grads = (grads.reshape(-1, k).sum(axis=1)
                    / (offset_mask.reshape(-1, k).sum(axis=1) + 1e-6))
    update_value = cfg.fork ** opt.update_ratio
    sel_level = grow["level"][:init_count][sel_idx // k]
    for cur_level in range(cfg.street_levels):
        if stage == "coarse":
            add_level = cur_level
        elif stage == "fine":
            add_level = max(cur_level + 1, cfg.aerial_levels)
        else:
            raise ValueError(f"invalid training stage {stage}")
        cur_level_mask = grow["level"][:init_count] == cur_level
        if cur_level_mask.sum() == 0:
            continue
        add_level_mask = grow["level"] == add_level

        cur_threshold = opt.densify_grad_threshold * (update_value ** cur_level)
        extra_threshold = cur_threshold * opt.extra_ratio

        # `grads` is grads_norm zeroed outside offset_mask: the candidate
        # rule of `lod_model.py:521-523`
        cand_sel = ((grads[sel_idx] >= cur_threshold)
                    & (sel_level == cur_level))
        cand_extra = (anchor_grads >= extra_threshold) & cur_level_mask
        if stage == "coarse":
            cand_extra &= grow["level"][:init_count] < cfg.aerial_levels
        else:
            cand_extra &= grow["level"][:init_count] >= cfg.aerial_levels
        grow["extra_add"] += opt.extra_up * cand_extra.astype(np.float32)

        voxel_size = cfg.voxel_size / (float(cfg.fork)
                                       ** (add_level - cfg.aerial_levels))
        grid_coords = np.round(grow["anchor"][add_level_mask] / voxel_size
                               - cfg.padding).astype(np.int64)
        sel_xyz = grow["xyz_sel"][cand_sel]
        sel_coords = np.round(sel_xyz / voxel_size
                              - cfg.padding).astype(np.int64)
        uniq, inverse = np.unique(sel_coords, axis=0, return_inverse=True)
        if getattr(opt, "overlap", False):
            keep_new = np.ones(uniq.shape[0], dtype=bool)
        else:
            keep_new = ~_dedup_against(grid_coords, uniq)
        cand_anchor = (uniq[keep_new].astype(np.float32) * voxel_size
                       + cfg.padding * voxel_size)
        new_level = np.full(cand_anchor.shape[0], add_level, dtype=np.int32)
        if (cand_anchor.shape[0] > 0 and weed_ratio > 0
                and cam_infos is not None):
            weed = weed_out_mask(cfg, cand_anchor, new_level, cam_infos,
                                 weed_ratio)
            sub = keep_new.copy()
            keep_new[sub] = weed
            cand_anchor = cand_anchor[weed]
            new_level = new_level[weed]
        if cand_anchor.shape[0] == 0:
            continue
        feat_rep = grow["feat_sel"][cand_sel]
        new_feat = _scatter_max_by_group(feat_rep, inverse,
                                         uniq.shape[0])[keep_new]
        _append_rows(grow, cand_anchor, new_feat,
                     np.log(np.full((cand_anchor.shape[0], 6), voxel_size,
                                    dtype=np.float32)),
                     new_level)


def _append_rows(grow: dict, new_anchor: np.ndarray, new_feat: np.ndarray,
                 new_scaling_log: np.ndarray, new_level: np.ndarray):
    """Record grown rows: extend the small anchor/level arrays (later
    levels dedup against them) and the new-row payload lists. Offsets,
    rotation, moments and statistics of new rows are constants (zeros,
    identity) that the repack writes."""
    grow["anchor"] = np.concatenate([grow["anchor"], new_anchor])
    grow["level"] = np.concatenate([grow["level"], new_level])
    grow["new_anchor"].append(new_anchor)
    grow["new_feat"].append(new_feat.astype(np.float32))
    grow["new_scaling_log"].append(new_scaling_log)
    grow["new_level"].append(new_level)


def _offset_mask(opt, stats: DensifyStats):
    """(offset_mask, opac or None): well-observed offsets, by the JAX
    package's formulas (padding rows have denom 0, so they are False)."""
    ui_st = float(opt.update_interval) * float(opt.success_threshold)
    od = stats.offset_denom
    if opt.growing_type == "max":
        opac = torch.nan_to_num(torch.where(
            od > 0, stats.offset_opacity_accum / torch.clamp_min(od, 1e-12),
            torch.zeros_like(od)))
        return (od > ui_st * 0.5) & (opac > 0.15), opac
    if opt.growing_type == "mean":
        return od > ui_st * 0.5, None
    raise ValueError(f"Unknown growing_type: {opt.growing_type}")


def _decision(opt, stats: DensifyStats):
    """grads_norm and offset_mask (C*k,) on the device: the only per-offset
    data the host decision needs."""
    od = stats.offset_denom
    og = stats.offset_gradient_accum
    offset_mask, opac = _offset_mask(opt, stats)
    if opt.growing_type == "mean":
        grads = torch.where(od > 0, og / torch.clamp_min(od, 1e-12),
                            torch.zeros_like(od))
        return torch.abs(torch.nan_to_num(grads)), offset_mask
    grads_norm = (torch.abs(torch.nan_to_num(og)) * stats.max_radii2d
                  * torch.pow(torch.clamp_min(opac, 0.0), 1 / 5.0))
    return grads_norm, offset_mask


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_(True)


@torch.no_grad()
def run_densify(cfg: ModelConfig, opt, state: TrainState, iteration: int,
                stage: str = "coarse",
                rng: Optional[np.random.Generator] = None,
                cam_infos: Optional[np.ndarray] = None,
                weed_ratio: float = 0.0,
                capacity_block: int = 4096,
                report: Optional[dict] = None) -> TrainState:
    """One grow+prune epoch (`run_densify`, `basic_model.py:212-295`);
    returns the new state (the input state is left as it was). `report`,
    when given, receives the rows "added" and "pruned", and the host-clock
    ms of the three phases: "decision_ms" (device decision arrays and
    candidate gather, and their copy to the host), "grow_ms" (the host
    grow/prune decision) and "repack_ms" (the device repack, waited
    for)."""
    rng = rng or np.random.default_rng(iteration)
    k = cfg.n_offsets
    n = int(state.n)
    C = state.params.anchor.shape[0]
    p = state.params
    dev = p.anchor.device
    t0 = time.perf_counter()

    # phase A (device): decision arrays; pull the small ones
    grads_norm_d, offset_mask_d = _decision(opt, state.stats)
    grads_norm = _host(grads_norm_d)[:n * k]
    offset_mask = _host(offset_mask_d)[:n * k]
    anchor_h = _host(p.anchor[:n])
    level_h = _host(state.level[:n])
    aopa_h = _host(state.stats.anchor_opacity_accum[:n])
    adem_h = _host(state.stats.anchor_demon[:n])

    # phase B (device gather): candidate rows' xyz and feat
    masked = grads_norm.copy()
    masked[~offset_mask] = 0.0
    if cfg.is_lod:
        uv = cfg.fork ** opt.update_ratio
        min_thr = min(opt.densify_grad_threshold * uv ** L
                      for L in range(cfg.street_levels))
        precand = masked >= min_thr
    else:
        min_thr = min(opt.densify_grad_threshold
                      * ((cfg.update_hierachy_factor // 2) ** i)
                      for i in range(cfg.update_depth))
        precand = (grads_norm >= min_thr) & offset_mask
    sel_idx = np.flatnonzero(precand).astype(np.int32)
    sel = torch.from_numpy(sel_idx.astype(np.int64)).to(dev)
    ar = sel // k
    xyz = (p.anchor[ar] + p.offset.reshape(-1, 3)[sel]
           * torch.exp(p.scaling_log[:, :3])[ar])
    grow = {
        "init_count": n, "sel_idx": sel_idx,
        "xyz_sel": _host(xyz), "feat_sel": _host(p.feat[ar]),
        "anchor": anchor_h.copy(), "level": level_h.copy(),
        "extra_add": np.zeros(n, np.float32),
        "new_anchor": [], "new_feat": [], "new_scaling_log": [],
        "new_level": [],
    }
    t1 = time.perf_counter()

    # grow (host decision logic, the JAX package's numerics)
    if cfg.is_lod:
        _grow_lod(cfg, opt, grow, grads_norm, offset_mask, stage,
                  cam_infos, weed_ratio)
    else:
        _grow_flat(cfg, opt, grow, grads_norm, offset_mask, rng,
                   cfg.voxel_size)

    if grow["new_anchor"]:
        new_anchor = np.concatenate(grow["new_anchor"]).astype(np.float32)
        new_feat = np.concatenate(grow["new_feat"]).astype(np.float32)
        new_scaling = np.concatenate(
            grow["new_scaling_log"]).astype(np.float32)
        new_level = np.concatenate(grow["new_level"]).astype(np.int32)
    else:
        new_anchor = np.zeros((0, 3), np.float32)
        new_feat = np.zeros((0, cfg.feat_dim), np.float32)
        new_scaling = np.zeros((0, 6), np.float32)
        new_level = np.zeros((0,), np.int32)
    m = new_anchor.shape[0]

    # prune (run_densify:254-295); grown rows are never pruned (their demon
    # statistic is zero, so anchors_mask gates them out)
    if opt.pruning_type == "mean":
        prune = aopa_h < opt.min_opacity * adem_h
    else:
        prune = aopa_h < opt.min_opacity
    anchors_mask = adem_h > opt.update_interval * opt.success_threshold
    prune = prune & anchors_mask
    if cfg.is_lod:
        if stage == "coarse":
            prune &= level_h < cfg.aerial_levels
        elif stage == "fine":
            prune &= level_h >= cfg.aerial_levels
    keep_idx = np.flatnonzero(~prune)
    n_keep = keep_idx.shape[0]
    n_new = n_keep + m
    C_new = C if n_new <= C else round_capacity(n_new, capacity_block)
    extra_add = np.zeros(C, np.float32)
    extra_add[:n] = grow["extra_add"]
    t2 = time.perf_counter()

    out = _repack(cfg, opt, state, C_new, torch.from_numpy(keep_idx).to(dev),
                  {"anchor": new_anchor, "feat": new_feat,
                   "scaling_log": new_scaling, "level": new_level},
                  torch.from_numpy(extra_add).to(dev))
    if report is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        report.update(added=m, pruned=n - n_keep,
                      decision_ms=(t1 - t0) * 1e3, grow_ms=(t2 - t1) * 1e3,
                      repack_ms=(t3 - t2) * 1e3)
    return out


def _repack(cfg: ModelConfig, opt, state: TrainState, C_new: int,
            src: torch.Tensor, new: dict, extra_add: torch.Tensor
            ) -> TrainState:
    """The device repack: the kept rows `src` first (in order), then the
    new rows, zeros after; the resets and the clamp of the JAX package's
    `_repack_fn`."""
    k = cfg.n_offsets
    p, st = state.params, state.stats
    dev = p.anchor.device
    n_keep = src.shape[0]
    n_new = n_keep + new["anchor"].shape[0]

    def rows(a):
        out = torch.zeros((C_new,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        out[:n_keep] = a[src]
        return out

    def with_new(out, name):
        out[n_keep:n_new] = torch.from_numpy(new[name]).to(dev)
        return out

    scaling = with_new(rows(p.scaling_log), "scaling_log")
    # the scaling clamp on prune (`_prune_anchor_optimizer`,
    # basic_model.py:162-166), on every surviving row
    scaling[:, 3:] = torch.clamp_max(scaling[:, 3:], 0.05)
    rotation = torch.zeros((C_new, 4), dtype=state.rotation.dtype,
                           device=dev)
    rotation[:, 0] = 1.0
    rotation[:n_keep] = state.rotation[src]
    params = TrainableParams(
        anchor=_leaf(with_new(rows(p.anchor), "anchor")),
        offset=_leaf(rows(p.offset)),
        feat=_leaf(with_new(rows(p.feat), "feat")),
        scaling_log=_leaf(scaling), mlps=copy.deepcopy(p.mlps))

    # the decoders and their moments are copied too: Adam updates them in
    # place, and the input state is to stay as it was
    def moments(groups):
        return {g: [rows(ts[0])] if g in TABLES else [t.clone() for t in ts]
                for g, ts in groups.items()}

    # statistics: reset the well-observed rows, then gather
    offset_mask, _ = _offset_mask(opt, st)
    ui_st = float(opt.update_interval) * float(opt.success_threshold)
    anchors_mask = st.anchor_demon > ui_st
    off_src = (src[:, None] * k
               + torch.arange(k, device=dev)[None, :]).reshape(-1)

    def goff(a):
        out = torch.zeros(C_new * k, dtype=a.dtype, device=dev)
        out[:n_keep * k] = torch.where(offset_mask, torch.zeros_like(a),
                                       a)[off_src]
        return out

    def ganch(a):
        return rows(torch.where(anchors_mask, torch.zeros_like(a), a))

    stats = DensifyStats(
        anchor_opacity_accum=ganch(st.anchor_opacity_accum),
        anchor_demon=ganch(st.anchor_demon),
        offset_gradient_accum=goff(st.offset_gradient_accum),
        offset_denom=goff(st.offset_denom),
        offset_opacity_accum=goff(st.offset_opacity_accum),
        max_radii2d=torch.zeros(C_new * k, dtype=torch.float32, device=dev))
    return TrainState(
        params=params, rotation=rotation,
        level=with_new(rows(state.level), "level"),
        extra_level=rows(state.extra_level + extra_add), n=n_new,
        opt=AdamState(mu=moments(state.opt.mu), nu=moments(state.opt.nu),
                      t=state.opt.t),
        stats=stats)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[:a.shape[0]] = a.detach()
    return out


@torch.no_grad()
def pad_state_capacity(state: TrainState, C_new: int) -> TrainState:
    """The state with its padded capacity grown to C_new rows and no live
    row changed (zeros, identity rotation, zero moments and statistics in
    the new rows)."""
    C = state.params.anchor.shape[0]
    if C_new == C:
        return state
    if C_new < C:
        raise ValueError(f"cannot shrink capacity {C} -> {C_new}")
    rot = torch.zeros((C_new, 4), dtype=state.rotation.dtype,
                      device=state.rotation.device)
    rot[:, 0] = 1.0
    rot[:C] = state.rotation
    p = state.params
    params = p._replace(**{t: _leaf(_pad_rows(getattr(p, t), C_new))
                           for t in TABLES})

    def moments(groups):
        return {g: [_pad_rows(ts[0], C_new)] if g in TABLES else ts
                for g, ts in groups.items()}

    # per-anchor statistics have C rows, per-offset ones C*k
    stats = DensifyStats(*(_pad_rows(a, C_new * (a.shape[0] // C))
                           for a in state.stats))
    return state._replace(
        params=params, rotation=rot, level=_pad_rows(state.level, C_new),
        extra_level=_pad_rows(state.extra_level, C_new),
        opt=state.opt._replace(mu=moments(state.opt.mu),
                               nu=moments(state.opt.nu)),
        stats=stats)


def clean_stats(state: TrainState, cfg: ModelConfig) -> TrainState:
    """`gaussians.clean()` at update_until (`train.py:270-273`)."""
    C = state.params.anchor.shape[0]
    return state._replace(stats=init_stats(C, cfg.n_offsets,
                                           state.params.anchor.device))


@torch.no_grad()
def roll_back(state: TrainState, base: dict, cfg: ModelConfig) -> TrainState:
    """Fine-stage rollback (`lod_model.py:673-679`, `base_model.py:559-564`):
    restore the pretrained (coarse-level) rows from the frozen base copies.
    `base` holds numpy arrays anchor, offset, feat, scaling_log and
    rotation of the pretrained rows, in their original order. Valid because
    fine-stage pruning never touches levels < aerial_levels and growth
    appends rows."""
    n = int(state.n)
    if cfg.is_lod:
        base_rows = np.flatnonzero(_host(state.level[:n]) < cfg.aerial_levels)
    else:
        base_rows = np.arange(base["anchor"].shape[0])
    if base_rows.shape[0] != base["anchor"].shape[0]:
        raise ValueError(f"rollback mismatch: {base_rows.shape[0]} vs "
                         f"{base['anchor'].shape[0]}")
    dev = state.params.anchor.device
    idx = torch.from_numpy(base_rows).to(dev)

    def restore(a, name):
        out = a.detach().clone()
        out[idx] = torch.as_tensor(np.asarray(base[name]), dtype=a.dtype).to(
            dev)
        return out

    p = state.params
    params = p._replace(**{t: _leaf(restore(getattr(p, t), t))
                           for t in TABLES})
    return state._replace(params=params,
                          rotation=restore(state.rotation, "rotation"))


@torch.no_grad()
def state_checksum(state: TrainState) -> torch.Tensor:
    """float64 fingerprint of a state's decision outputs: n, capacity, the
    levels and every table's sum and sum of squares."""
    p = state.params
    dev = p.anchor.device
    parts = [torch.tensor([float(state.n), float(p.anchor.shape[0])],
                          dtype=torch.float64, device=dev),
             state.level.double().sum()[None],
             state.extra_level.double().sum()[None]]
    for t in TABLES:
        x = getattr(p, t).detach().double()
        parts += [x.sum()[None], (x * x).sum()[None]]
    return torch.cat(parts)


@torch.no_grad()
def run_densify_sharded(cfg: ModelConfig, opt, state: TrainState, mesh,
                        iteration: int, stage: str = "coarse",
                        rng: Optional[np.random.Generator] = None,
                        cam_infos: Optional[np.ndarray] = None,
                        weed_ratio: float = 0.0,
                        capacity_block: int = 4096,
                        report: Optional[dict] = None,
                        base: Optional[dict] = None) -> TrainState:
    """A densify epoch of a sharded state (`parallel/step.shard_state`):
    gather it over "model" onto every rank, run `run_densify` unchanged on
    each (the decision is deterministic: the same statistics and the same
    seeded `rng` on every rank), check with one all_reduce of a checksum
    that every rank reached the same n, levels and tables, and return the
    rank's slice of the result. `capacity_block` must be a multiple of the
    "model" axis (the trainer passes lcm(4096, model)). `base`: the fine
    stage's rollback copies, restored before the epoch."""
    from horizongs_tpu_torch.parallel.collectives import pmax
    from horizongs_tpu_torch.parallel.step import shard_state, unshard_state
    if capacity_block % mesh.shape["model"]:
        raise ValueError(f"capacity block {capacity_block} does not divide "
                         f"model={mesh.shape['model']}")
    full = unshard_state(state, mesh)
    if base is not None:
        full = roll_back(full, base, cfg)
    new = run_densify(cfg, opt, full, iteration, stage=stage, rng=rng,
                      cam_infos=cam_infos, weed_ratio=weed_ratio,
                      capacity_block=capacity_block, report=report)
    s = state_checksum(new)
    world = mesh.group("world")
    if not torch.equal(pmax(s, world), -pmax(-s, world)):
        raise RuntimeError(f"densify diverged across ranks at iteration "
                           f"{iteration}: the ranks reached different "
                           f"n, levels or tables")
    return shard_state(new, mesh)
