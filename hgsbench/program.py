"""The system under test, fed with the benchmark's inputs.

The only module of the benchmark besides the cell drivers that imports
the program (`horizongs_tpu_torch`): it wraps the benchmark's tensors
(`scene.Tables`, `scene.Views`) in the program's types, and builds the
`Trainer` on a stand-in for the program's `Scene` that holds them.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from horizongs_tpu_torch.config import parse_cfg
from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders, TwoLayerMLP
from horizongs_tpu_torch.train.step import init_train_state
from horizongs_tpu_torch.train.trainer import Trainer

from hgsbench.scene import Tables, Views, cameras_extent


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig.from_dict(cfg["yaml"]["model_params"]["model_config"])


def namespaces(cfg: dict):
    """(lp, op, pp) of the configuration's YAML namespaces."""
    return parse_cfg(cfg["yaml"])


def anchor_state(t: Tables) -> AnchorState:
    return AnchorState(anchor=t.anchor, offset=t.offset, feat=t.feat,
                       scaling_log=t.scaling_log, rotation=t.rotation,
                       level=t.level, extra_level=t.extra_level, n=t.n)


def decoders(t: Tables) -> MlpDecoders:
    """The decoders, with the appearance table where the tables hold one
    (its row is the camera's uid)."""
    def mlp(name, tanh=False):
        return TwoLayerMLP(*t.mlp[name], final_tanh=tanh)
    app = t.mlp.get("appearance")
    return MlpDecoders(mlp("opacity", True), mlp("cov"), mlp("color"),
                       None if app is None else app[0])


def cameras(views: Views) -> list:
    """The views as the program's cameras, with their targets; uid = the
    view's index."""
    return [Camera(viewmat=views.viewmat[i], K=views.K[i],
                   width=views.width, height=views.height,
                   cam_center=views.center[i], uid=i,
                   image=views.image[i], alpha_mask=views.alpha_mask[i],
                   invdepth=views.invdepth[i],
                   depth_mask=views.depth_mask[i],
                   image_type="aerial" if views.is_aerial[i] else "street")
            for i in range(len(views.is_aerial))]


def trainer(cfg: dict, tables: Tables, views: Views, seed: int,
            model_path: str, device, mesh=None) -> Trainer:
    """The program's `Trainer` over a coarse-stage scene that holds the
    benchmark's table (as a fresh training state: Adam moments and
    statistics at zero) and views, on `mesh` where given (this rank's
    `parallel.mesh.Mesh`); logging goes nowhere."""
    _, op, pp = namespaces(cfg)
    cams = cameras(views)
    scene = SimpleNamespace(
        device=torch.device(device), model_path=model_path,
        stage="coarse", base=None, frozen_mlps=False,
        frozen_appearance=False, weed_ratio=0.0,
        background=torch.zeros(3, device=device),
        cameras_extent=cameras_extent(views),
        cam_infos=np.array([[*views.center[i].tolist(), 1.0]
                            for i in range(len(cams))], dtype=np.float32),
        train_state=init_train_state(anchor_state(tables), decoders(tables)),
        get_train_cameras=lambda: cams, get_test_cameras=lambda: [],
        save=None)
    os.makedirs(model_path, exist_ok=True)
    logger = SimpleNamespace(info=lambda *a, **k: None)
    return Trainer(model_config(cfg), op, pp, scene, logger=logger,
                   rasterizer="cuda", seed=seed, mesh=mesh)
