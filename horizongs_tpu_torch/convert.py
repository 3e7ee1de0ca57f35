"""Carry the JAX package's model and training state across, and back.

The JAX package keeps its model as pytrees (`TrainableParams`,
`AnchorState`, `MlpParams`, `TrainState` with `AdamState` and
`DensifyStats`). Given their leaves as numpy arrays, these functions build
the port's `AnchorState`, `MlpDecoders` and `TrainState` with the same
values, so both packages compute the same thing; `train_state_to_numpy`
gives the port's state back in the JAX package's layout, so the two can
be compared after a step. The decoders' weights are stored (in, out) in
both, so the copy is plain. Nothing here imports JAX: the caller turns its
arrays into numpy (`jax.tree.map(np.asarray, ...)`) first.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.mlp import MlpDecoders, TwoLayerMLP
from horizongs_tpu_torch.train.optim import (
    MLP_GROUPS,
    AdamState,
    Groups,
    TrainableParams,
)
from horizongs_tpu_torch.train.step import DensifyStats, TrainState

_TABLES = ("anchor", "offset", "feat", "scaling_log")


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype).to(dev)


def anchor_state_from_numpy(leaves: Mapping[str, np.ndarray],
                            device: DeviceLike = None) -> AnchorState:
    """`leaves`: anchor, offset, feat, scaling_log, rotation, level,
    extra_level and n, as in the JAX package's `AnchorState` (the first
    four are also `TrainableParams` fields)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return AnchorState(
        anchor=_tensor(leaves["anchor"], f32, dev),
        offset=_tensor(leaves["offset"], f32, dev),
        feat=_tensor(leaves["feat"], f32, dev),
        scaling_log=_tensor(leaves["scaling_log"], f32, dev),
        rotation=_tensor(leaves["rotation"], f32, dev),
        level=_tensor(leaves["level"], torch.int32, dev),
        extra_level=_tensor(leaves["extra_level"], f32, dev),
        n=int(np.asarray(leaves["n"])),
    )


def _two_layer(p: Mapping, dev: torch.device, final_tanh: bool = False
               ) -> TwoLayerMLP:
    f32 = torch.float32
    return TwoLayerMLP(_tensor(p["l1"]["w"], f32, dev),
                       _tensor(p["l1"]["b"], f32, dev),
                       _tensor(p["l2"]["w"], f32, dev),
                       _tensor(p["l2"]["b"], f32, dev),
                       final_tanh=final_tanh)


def mlps_from_numpy(opacity: Mapping, cov: Mapping, color: Mapping,
                    appearance: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> MlpDecoders:
    """Each MLP as the JAX package's {"l1": {"w", "b"}, "l2": {"w", "b"}}
    (`MlpParams` fields, or `TrainableParams.mlp_*`)."""
    dev = resolve_device(device)
    app = (None if appearance is None
           else _tensor(appearance, torch.float32, dev))
    return MlpDecoders(_two_layer(opacity, dev, final_tanh=True),
                       _two_layer(cov, dev), _two_layer(color, dev), app)


def _mlp_leaves(p: Mapping) -> list:
    """{"l1": {"w", "b"}, "l2": {"w", "b"}} -> [w1, b1, w2, b2]."""
    return [p["l1"]["w"], p["l1"]["b"], p["l2"]["w"], p["l2"]["b"]]


def _groups_from_numpy(tp: Any, dev: torch.device) -> Groups:
    """A JAX `TrainableParams` of numpy leaves -> the port's groups."""
    out = {k: [_tensor(getattr(tp, k), torch.float32, dev)]
           for k in _TABLES}
    for k in MLP_GROUPS:
        out[k] = [_tensor(a, torch.float32, dev)
                  for a in _mlp_leaves(getattr(tp, k))]
    out["appearance"] = ([] if tp.appearance is None else
                         [_tensor(tp.appearance, torch.float32, dev)])
    return out


def train_state_from_numpy(ts: Any, device: DeviceLike = None) -> TrainState:
    """`ts`: the JAX package's `TrainState` with numpy leaves. The anchor
    tables become leaves that require grad; moments, step count and
    densification statistics are copied."""
    dev = resolve_device(device)
    p = ts.params
    mlps = mlps_from_numpy(p.mlp_opacity, p.mlp_cov, p.mlp_color,
                           p.appearance, device=dev)
    params = TrainableParams(
        **{k: _tensor(getattr(p, k), torch.float32, dev).requires_grad_(True)
           for k in _TABLES}, mlps=mlps)
    opt = AdamState(mu=_groups_from_numpy(ts.opt.mu, dev),
                    nu=_groups_from_numpy(ts.opt.nu, dev),
                    t=int(np.asarray(ts.opt.t)))
    stats = DensifyStats(*(_tensor(getattr(ts.stats, f), torch.float32, dev)
                           for f in DensifyStats._fields))
    return TrainState(params=params,
                      rotation=_tensor(ts.rotation, torch.float32, dev),
                      level=_tensor(ts.level, torch.int32, dev),
                      extra_level=_tensor(ts.extra_level, torch.float32, dev),
                      n=int(np.asarray(ts.n)), opt=opt, stats=stats)


def _groups_to_numpy(groups: Groups) -> dict:
    def a(t):
        return t.detach().cpu().numpy()
    out = {k: a(groups[k][0]) for k in _TABLES}
    for k in MLP_GROUPS:
        w1, b1, w2, b2 = (a(t) for t in groups[k])
        out[k] = {"l1": {"w": w1, "b": b1}, "l2": {"w": w2, "b": b2}}
    out["appearance"] = (a(groups["appearance"][0])
                         if groups["appearance"] else None)
    return out


def train_state_to_numpy(ts: TrainState) -> dict:
    """The port's state as nested dicts of numpy arrays in the JAX
    package's layout: {"params", "mu", "nu"} each keyed by the
    `TrainableParams` fields (MLPs as {"l1": {"w", "b"}, "l2": ...}),
    "t", and "stats" keyed by the `DensifyStats` fields."""
    return {"params": _groups_to_numpy(ts.params.groups()),
            "mu": _groups_to_numpy(ts.opt.mu),
            "nu": _groups_to_numpy(ts.opt.nu),
            "t": ts.opt.t,
            "stats": {f: getattr(ts.stats, f).detach().cpu().numpy()
                      for f in DensifyStats._fields}}
