"""Carry the JAX package's parameters across to this package.

The JAX package keeps its model as pytrees (`TrainableParams`,
`AnchorState`, `MlpParams`). Given their leaves as numpy arrays, these
functions build the port's `AnchorState` and `MlpDecoders` with the same
values, so both packages compute the same thing. The decoders' weights are
stored (in, out) in both, so the copy is plain. Nothing here imports JAX:
the caller turns its arrays into numpy (`np.asarray`) first.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.models.anchors import AnchorState
from horizongs_tpu_torch.models.mlp import MlpDecoders, TwoLayerMLP


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
