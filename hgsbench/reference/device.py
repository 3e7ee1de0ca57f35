# Frozen copy of horizongs_tpu_torch/device.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""Device selection for the public entry points.

Entry points that build tensors take `device=None` and put them on the
card. Nothing falls back to the CPU on its own: with no card visible the
default raises, and the CPU is used only when a caller asks for it, as the
tests do with `device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the current CUDA device when it is None."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to build "
                "tensors on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def disable_tf32() -> None:
    """Full float32 for matmuls and convolutions on the card (cuDNN
    defaults to TF32, which keeps about three decimal digits); parity
    checks against the plain versions and the JAX package call this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
