"""Model assembly helpers shared by `Scene`, the trainer and the tests:
the JAX package's `models/factory.py`. Its `make_train_state` is
`train.step.init_train_state` here."""
from __future__ import annotations

import torch

from horizongs_tpu_torch.device import DeviceLike
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders, init_mlps


def new_mlps(cfg: ModelConfig, num_cameras: int = 0, seed: int = 0,
             device: DeviceLike = None) -> MlpDecoders:
    """Freshly initialised decoders from a seeded `torch.Generator` (so
    the weights differ from the JAX package's `PRNGKey` init; parity
    tests carry weights across with `convert.py`)."""
    return init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim, num_cameras=num_cameras,
                     generator=torch.Generator().manual_seed(seed),
                     device=device)


def base_copies(state: AnchorState) -> dict:
    """Host copies of the live rows for the fine stage's rollback
    (`create_from_pretrained` base_* params, `lod_model.py:657-661`)."""
    n = int(state.n)
    return {k: getattr(state, k)[:n].detach().cpu().numpy().copy()
            for k in ("anchor", "offset", "feat", "scaling_log",
                      "rotation")}
