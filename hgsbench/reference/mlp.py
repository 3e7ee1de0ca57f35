# Frozen copy of horizongs_tpu_torch/models/mlp.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""The three decode MLPs (Linear-ReLU-Linear; the opacity head ends in
tanh) as `nn.Module`s.

Weights are stored (in, out), the JAX package's layout, so carrying its
parameters across (`convert.py`) is a plain copy. Init matches torch
`nn.Linear` defaults (Kaiming-uniform weights, fan-in uniform bias), drawn
from an explicit `torch.Generator` on the CPU and then moved, so a seed
gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hgsbench.reference.device import DeviceLike, resolve_device


class TwoLayerMLP(nn.Module):
    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, final_tanh: bool = False):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)
        self.final_tanh = final_tanh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        out = h @ self.w2 + self.b2
        return torch.tanh(out) if self.final_tanh else out


class MlpDecoders(nn.Module):
    """Counterpart of the JAX package's `MlpParams`: opacity
    (F+view -> F -> k, tanh), cov (-> 7k), color (F+view+appearance ->
    F -> color_dim*k) and the optional per-camera appearance table."""

    def __init__(self, opacity: TwoLayerMLP, cov: TwoLayerMLP,
                 color: TwoLayerMLP,
                 appearance: Optional[torch.Tensor] = None):
        super().__init__()
        self.opacity = opacity
        self.cov = cov
        self.color = color
        self.appearance = (None if appearance is None
                           else nn.Parameter(appearance))


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def init_2layer(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int,
                device: torch.device, final_tanh: bool = False
                ) -> TwoLayerMLP:
    bound_w1 = math.sqrt(1.0 / d_in) * math.sqrt(3.0)  # kaiming_uniform(a=sqrt(5))
    bound_w2 = math.sqrt(1.0 / d_hidden) * math.sqrt(3.0)
    w1 = _uniform(gen, (d_in, d_hidden), bound_w1)
    b1 = _uniform(gen, (d_hidden,), 1.0 / math.sqrt(d_in))
    w2 = _uniform(gen, (d_hidden, d_out), bound_w2)
    b2 = _uniform(gen, (d_out,), 1.0 / math.sqrt(d_hidden))
    return TwoLayerMLP(w1.to(device), b1.to(device), w2.to(device),
                       b2.to(device), final_tanh=final_tanh)


def init_mlps(feat_dim: int, view_dim: int, appearance_dim: int,
              n_offsets: int, color_dim: int, num_cameras: int = 0,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> MlpDecoders:
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator()
    opacity = init_2layer(gen, feat_dim + view_dim, feat_dim, n_offsets,
                          dev, final_tanh=True)
    cov = init_2layer(gen, feat_dim + view_dim, feat_dim, 7 * n_offsets, dev)
    color = init_2layer(gen, feat_dim + view_dim + appearance_dim, feat_dim,
                        color_dim * n_offsets, dev)
    appearance = None
    if appearance_dim > 0:
        appearance = torch.randn((max(num_cameras, 1), appearance_dim),
                                 generator=gen).to(dev)
    return MlpDecoders(opacity, cov, color, appearance)
