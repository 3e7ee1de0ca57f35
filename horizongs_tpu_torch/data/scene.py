"""Scene orchestration: dataset -> cameras -> model state.

The JAX package's `data/scene.py` (a functional port of
`scene/__init__.py`): loads the dataset through the format callbacks,
builds the camera lists per resolution scale on the device, writes
input.ply and cameras.json, and initialises the training state from the
point cloud (coarse stage, with the optional camera weed-out), from a
pretrained coarse iteration directory or a model directory, whose last
saved iteration it takes (fine stage: frozen MLPs and the rollback base
copies, `create_from_pretrained`), or from a saved
iteration; with `explicit=True` a saved iteration loads as the baked
explicit model (`explicit_state`, no training state). `save` bakes a
view-independent SH model to point_cloud_explicit.ply beside the anchors.
`write_files=False` writes nothing (the ranks of a mesh other than 0).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from horizongs_tpu_torch.data.camera_build import camera_list, camera_to_json
from horizongs_tpu_torch.data.readers import scene_load_callbacks
from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.io.checkpoints import (
    load_anchor_ply,
    load_explicit_ply,
    load_mlp_checkpoints,
    save_anchor_ply,
    save_explicit_ply,
    save_mlp_checkpoints,
    search_max_iteration,
)
from horizongs_tpu_torch.io.plyio import write_points_ply
from horizongs_tpu_torch.models.anchors import (
    init_anchor_state_from_points,
    weed_out_mask,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.explicit import (
    bake_explicit,
    explicit_state_from_arrays,
)
from horizongs_tpu_torch.models.factory import base_copies, new_mlps
from horizongs_tpu_torch.train.step import TrainState, init_train_state


class Scene:
    def __init__(self, lp, cfg: ModelConfig, load_iteration=None,
                 explicit: bool = False,
                 weed_ratio: float = 0.0, logger=None, seed: int = 0,
                 device: DeviceLike = None, write_files: bool = True):
        self.lp = lp
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.model_path = lp.model_path
        self.weed_ratio = weed_ratio
        self.stage = "coarse"
        self.base = None             # fine-stage rollback copies
        self.frozen_mlps = False
        self.frozen_appearance = False
        log = logger.info if logger else print

        if getattr(lp, "random_background", False):
            # the global numpy RNG, as the JAX package draws it
            bg = np.random.rand(3).astype(np.float32)
        elif getattr(lp, "white_background", False):
            bg = np.ones(3, np.float32)
        else:
            bg = np.zeros(3, np.float32)
        self.background = torch.from_numpy(bg).to(dev)

        self.loaded_iter = None
        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            log(f"Loading trained model at iteration {self.loaded_iter}")

        loader = scene_load_callbacks[lp.data_format]
        kwargs = dict(eval=lp.eval, add_mask=lp.add_mask,
                      add_depth=lp.add_depth, add_aerial=lp.add_aerial,
                      add_street=lp.add_street, center=lp.center,
                      scale=lp.scale, llffhold=getattr(lp, "llffhold", 32),
                      images=lp.images)
        scene_info = loader(lp.source_path, **kwargs)
        if scene_info.point_cloud.points.shape[0] == 0:
            raise ValueError(
                f"{scene_info.ply_path} holds no points: a chunk whose "
                f"bounds take in none of the scene's points cannot be "
                f"trained (partition it with fewer chunks)")
        self.scene_info = scene_info
        self.cameras_extent = scene_info.nerf_normalization["radius"]

        ratio = max(int(getattr(lp, "ratio", 1)), 1)
        pts = scene_info.point_cloud.points[::ratio]
        if not self.loaded_iter and self.model_path and write_files:
            os.makedirs(self.model_path, exist_ok=True)
            log(f"Train cameras: {len(scene_info.train_cameras)}")
            log(f"Test cameras: {len(scene_info.test_cameras)}")
            write_points_ply(os.path.join(self.model_path, "input.ply"),
                             pts, scene_info.point_cloud.colors[::ratio])
            cam_json = [camera_to_json(i, c) for i, c in enumerate(
                scene_info.test_cameras + scene_info.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump(cam_json, f)

        self.train_cameras: Dict[float, list] = {}
        self.test_cameras: Dict[float, list] = {}
        for rs in lp.resolution_scales:
            self.train_cameras[rs] = camera_list(scene_info.train_cameras,
                                                 lp, rs, device=dev)
            self.test_cameras[rs] = camera_list(scene_info.test_cameras,
                                                lp, rs, device=dev)

        # camera rows for the weed-out (`scene/__init__.py:114-118`)
        train = self.get_train_cameras()
        self.cam_infos = np.array(
            [[*c.cam_center.cpu().numpy(), c.resolution_scale]
             for c in train], dtype=np.float32) \
            if train else np.zeros((0, 4), np.float32)

        # ---- model state ----
        self.train_state = self.explicit_state = None
        if self.loaded_iter:
            it_dir = os.path.join(self.model_path, "point_cloud",
                                  f"iteration_{self.loaded_iter}")
            if explicit:
                arrays, info = load_explicit_ply(
                    os.path.join(it_dir, "point_cloud_explicit.ply"))
                self.cfg = _fold_obj_info(self.cfg, info)
                self.explicit_state = explicit_state_from_arrays(
                    arrays, device=dev)
                return
            state, info = load_anchor_ply(
                os.path.join(it_dir, "point_cloud.ply"), self.cfg,
                device=dev)
            self.cfg = _fold_obj_info(self.cfg, info)
            mlps = load_mlp_checkpoints(it_dir, device=dev)
        elif getattr(lp, "pretrained_checkpoint", "") not in ("", None):
            # fine stage (`create_from_pretrained`, lod_model.py:619-671)
            self.stage = "fine"
            self.frozen_mlps = True
            ckpt = pretrained_iteration_dir(lp.pretrained_checkpoint)
            log(f"Fine stage from {ckpt}")
            state, info = load_anchor_ply(
                os.path.join(ckpt, "point_cloud.ply"), self.cfg, device=dev)
            self.cfg = _fold_obj_info(self.cfg, info)
            mlps = load_mlp_checkpoints(ckpt, device=dev)
            self.base = base_copies(state)
        else:
            weed_fn = None
            if weed_ratio > 0 and cfg.is_lod:
                weed_fn = lambda pos, lv: weed_out_mask(  # noqa: E731
                    cfg, pos, lv, self.cam_infos, weed_ratio)
            state = init_anchor_state_from_points(cfg, pts, weed_fn=weed_fn,
                                                  device=dev)
            log(f"Initial Voxel Number: {int(state.n)}")
            mlps = new_mlps(cfg, num_cameras=len(scene_info.train_cameras),
                            seed=seed, device=dev)
            if getattr(lp, "global_appearance", "") not in ("", None):
                it = search_max_iteration(
                    os.path.join(lp.global_appearance, "point_cloud"))
                mlps = load_mlp_checkpoints(os.path.join(
                    lp.global_appearance, "point_cloud", f"iteration_{it}"),
                    device=dev)
                self.frozen_appearance = True
        self.train_state = init_train_state(state, mlps)

    # ------------------------------------------------------------------
    def get_train_cameras(self) -> list:
        out = []
        for rs in self.lp.resolution_scales:
            out.extend(self.train_cameras[rs])
        return out

    def get_test_cameras(self) -> list:
        out = []
        for rs in self.lp.resolution_scales:
            out.extend(self.test_cameras[rs])
        return out

    def camera_bytes(self) -> int:
        """Device bytes the cameras' images, masks and depths take."""
        return sum(t.numel() * t.element_size()
                   for c in self.get_train_cameras() + self.get_test_cameras()
                   for t in (c.image, c.alpha_mask, c.invdepth, c.depth_mask)
                   if t is not None)

    def save(self, iteration: int, train_state: TrainState) -> None:
        """`Scene.save` (`scene/__init__.py:155-164`): anchor PLY and MLP
        weights, and the explicit bake where the colours are SH and
        view-independent ("Neural Gaussians do not have the SH property"
        / "are affected by viewpoint" otherwise)."""
        it_dir = os.path.join(self.model_path, "point_cloud",
                              f"iteration_{iteration}")
        os.makedirs(it_dir, exist_ok=True)
        astate = train_state.anchor_state()
        mlps = train_state.params.mlps
        save_anchor_ply(os.path.join(it_dir, "point_cloud.ply"), self.cfg,
                        astate)
        save_mlp_checkpoints(it_dir, mlps)
        if self.cfg.color_attr != "RGB" and self.cfg.view_dim == 0:
            save_explicit_ply(
                os.path.join(it_dir, "point_cloud_explicit.ply"), self.cfg,
                bake_explicit(self.cfg, mlps, astate))


def pretrained_iteration_dir(path: str) -> str:
    """The iteration directory a fine stage loads: `path` itself where it
    holds point_cloud.ply, else the highest `point_cloud/iteration_*`
    under it (a coarse model directory, as the chunk and single-scene
    configs name it; the JAX package raises FileNotFoundError there)."""
    if not os.path.exists(os.path.join(path, "point_cloud.ply")):
        it = search_max_iteration(os.path.join(path, "point_cloud"))
        if it >= 0:
            return os.path.join(path, "point_cloud", f"iteration_{it}")
    return path


def _fold_obj_info(cfg: ModelConfig, info: dict) -> ModelConfig:
    updates = {}
    if "standard_dist" in info:
        updates["standard_dist"] = float(info["standard_dist"])
    if "aerial_levels" in info:
        updates["aerial_levels"] = int(round(info["aerial_levels"]))
    if "street_levels" in info:
        updates["street_levels"] = int(round(info["street_levels"]))
    return dataclasses.replace(cfg, **updates) if updates else cfg
