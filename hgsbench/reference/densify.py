# Frozen copy of the decision, growth, pruning and table repack of
# horizongs_tpu_torch/train/densify.py at commit 9bef012, for the
# benchmark's plain reference: the program is never imported. The
# optimizer moments, statistics and rotations of the repacked state are
# left out: the benchmark compares the tables.
"""One grow+prune epoch of the LOD model, from a copy of the state the
epoch reads.

`epoch` takes host tensors (the statistics and tables of the state the
program's epoch was handed) and returns the tables that epoch should
leave: the kept rows in order, then the grown ones. The decision arrays
and the candidates' positions are computed on `device` with the same
torch operations as the program, so that on the program's device they
come out bit for bit; the growth decision runs in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from hgsbench.reference.anchors import round_capacity, weed_out_mask
from hgsbench.reference.config import ModelConfig

TABLES = ("anchor", "offset", "feat", "scaling_log", "level", "extra_level")


def _scatter_max_by_group(values: np.ndarray, groups: np.ndarray,
                          n_groups: int) -> np.ndarray:
    out = np.full((n_groups,) + values.shape[1:], -np.inf, dtype=values.dtype)
    np.maximum.at(out, groups, values)
    out[~np.isfinite(out)] = 0.0
    return out


def _rows_as_void(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1])))[:, 0]


def _dedup_against(existing: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    if existing.shape[0] == 0 or candidates.shape[0] == 0:
        return np.zeros(candidates.shape[0], dtype=bool)
    return np.isin(_rows_as_void(candidates), _rows_as_void(existing))


def _decision(opt, st: dict):
    """grads_norm and offset_mask over every offset row."""
    ui_st = float(opt.update_interval) * float(opt.success_threshold)
    od, og = st["offset_denom"], st["offset_gradient_accum"]
    if opt.growing_type == "mean":
        grads = torch.where(od > 0, og / torch.clamp_min(od, 1e-12),
                            torch.zeros_like(od))
        return torch.abs(torch.nan_to_num(grads)), od > ui_st * 0.5
    if opt.growing_type != "max":
        raise ValueError(f"Unknown growing_type: {opt.growing_type}")
    opac = torch.nan_to_num(torch.where(
        od > 0, st["offset_opacity_accum"] / torch.clamp_min(od, 1e-12),
        torch.zeros_like(od)))
    mask = (od > ui_st * 0.5) & (opac > 0.15)
    grads_norm = (torch.abs(torch.nan_to_num(og)) * st["max_radii2d"]
                  * torch.pow(torch.clamp_min(opac, 0.0), 1 / 5.0))
    return grads_norm, mask


def _grow_lod(cfg: ModelConfig, opt, grow: dict, grads_norm: np.ndarray,
              offset_mask: np.ndarray, stage: str, cam_infos, weed_ratio):
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
        grow["anchor"] = np.concatenate([grow["anchor"], cand_anchor])
        grow["level"] = np.concatenate([grow["level"], new_level])
        grow["new"].append((cand_anchor, new_feat.astype(np.float32),
                            np.log(np.full((cand_anchor.shape[0], 6),
                                           voxel_size, dtype=np.float32)),
                            new_level))


@torch.no_grad()
def epoch(cfg: ModelConfig, opt, snap: dict, device, stage: str = "coarse",
          cam_infos=None, weed_ratio: float = 0.0) -> dict:
    """The tables after one epoch over the snapshot `snap` (host tensors:
    the six statistics, `anchor`, `offset`, `feat`, `scaling_log`,
    `level`, `extra_level`, and the row count `n`): each table's first
    `n_new` rows, with "n", "added" and "pruned"."""
    if not cfg.is_lod:
        raise ValueError("the reference epoch covers the LOD model only")
    k, n = cfg.n_offsets, int(snap["n"])
    st = {name: snap[name].to(device) for name in
          ("offset_gradient_accum", "offset_denom", "offset_opacity_accum",
           "max_radii2d")}
    anchor, offset = snap["anchor"].to(device), snap["offset"].to(device)
    scaling = snap["scaling_log"].to(device)
    grads_norm_d, mask_d = _decision(opt, st)
    grads_norm = grads_norm_d.cpu().numpy()[:n * k]
    offset_mask = mask_d.cpu().numpy()[:n * k]
    masked = grads_norm.copy()
    masked[~offset_mask] = 0.0
    uv = cfg.fork ** opt.update_ratio
    min_thr = min(opt.densify_grad_threshold * uv ** L
                  for L in range(cfg.street_levels))
    sel_idx = np.flatnonzero(masked >= min_thr).astype(np.int32)
    sel = torch.from_numpy(sel_idx.astype(np.int64)).to(device)
    ar = sel // k
    xyz = (anchor[ar] + offset.reshape(-1, 3)[sel]
           * torch.exp(scaling[:, :3])[ar])
    level_h = snap["level"][:n].numpy()
    grow = {"init_count": n, "sel_idx": sel_idx,
            "xyz_sel": xyz.cpu().numpy(),
            "feat_sel": snap["feat"][ar.cpu()].numpy(),
            "anchor": snap["anchor"][:n].numpy().copy(),
            "level": level_h.copy(), "extra_add": np.zeros(n, np.float32),
            "new": []}
    _grow_lod(cfg, opt, grow, grads_norm, offset_mask, stage, cam_infos,
              weed_ratio)
    new = [np.concatenate(parts) for parts in zip(*grow["new"])] or [
        np.zeros((0, 3), np.float32), np.zeros((0, cfg.feat_dim), np.float32),
        np.zeros((0, 6), np.float32), np.zeros((0,), np.int32)]
    m = new[0].shape[0]

    aopa = snap["anchor_opacity_accum"][:n].numpy()
    adem = snap["anchor_demon"][:n].numpy()
    if opt.pruning_type == "mean":
        prune = aopa < opt.min_opacity * adem
    else:
        prune = aopa < opt.min_opacity
    prune &= adem > opt.update_interval * opt.success_threshold
    if stage == "coarse":
        prune &= level_h < cfg.aerial_levels
    elif stage == "fine":
        prune &= level_h >= cfg.aerial_levels
    keep = torch.from_numpy(np.flatnonzero(~prune))
    n_keep = keep.shape[0]

    def rows(a, add=None):
        kept = a[keep]
        if add is None:
            add = torch.zeros((m,) + tuple(a.shape[1:]), dtype=a.dtype)
        return torch.cat([kept, torch.as_tensor(add, dtype=a.dtype)])

    extra = snap["extra_level"][:n] + torch.from_numpy(grow["extra_add"])
    out = {"anchor": rows(snap["anchor"], new[0]),
           "offset": rows(snap["offset"]),
           "feat": rows(snap["feat"], new[1]),
           "scaling_log": rows(snap["scaling_log"], new[2]),
           "level": rows(snap["level"], new[3]),
           "extra_level": rows(extra)}
    out["scaling_log"][:, 3:] = torch.clamp_max(out["scaling_log"][:, 3:],
                                                0.05)
    out.update(n=n_keep + m, added=m, pruned=n - n_keep,
               capacity=round_capacity(n_keep + m))
    return out


def rows_off(prog: dict, ref: dict) -> float:
    """Rows of the tables after the epoch where the program's differ from
    the reference's in any table, plus the difference of their row
    counts, over the rows the reference's epoch added and pruned."""
    n = min(int(prog["n"]), int(ref["n"]))
    bad = torch.zeros(n, dtype=torch.bool)
    for name in TABLES:
        a, b = prog[name][:n], ref[name][:n]
        bad |= (a != b).reshape(n, -1).any(dim=1)
    off = int(bad.sum()) + abs(int(prog["n"]) - int(ref["n"]))
    return off / max(int(ref["added"]) + int(ref["pruned"]), 1)
