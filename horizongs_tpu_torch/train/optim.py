"""Functional Adam with per-group LRs, written by hand on tensors.

The JAX package's `train/optim.py`: the optimiser groups of Horizon-GS's
`training_setup` (anchor, offset, feat, scaling_log, the three MLPs and the
appearance table; rotation is stored, not optimised), bias correction on
both moments and eps added after the square root, as
`torch.optim.Adam(..., eps=1e-15)` computes it. `torch.optim.Adam` is not
used: the moments are plain tensors held per group beside the parameters,
so densification can cut and grow their rows together with the tables'.

Unlike the JAX package, which returns new arrays, `adam_step` updates the
parameters and the moments in place (under `torch.no_grad()`, with
`torch._foreach_*`), which keeps one copy of each in device memory.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from horizongs_tpu_torch.models.mlp import MlpDecoders

GROUPS = ("anchor", "offset", "feat", "scaling_log", "mlp_opacity",
          "mlp_cov", "mlp_color", "appearance")
MLP_GROUPS = ("mlp_opacity", "mlp_cov", "mlp_color")

Groups = Dict[str, List[torch.Tensor]]


class TrainableParams(NamedTuple):
    """The optimised tensors: the anchor tables (leaves that require grad)
    and the decoders, whose `nn.Parameter`s are the MLP and appearance
    groups."""
    anchor: torch.Tensor       # (C, 3)
    offset: torch.Tensor       # (C, k, 3)
    feat: torch.Tensor         # (C, F)
    scaling_log: torch.Tensor  # (C, 6)
    mlps: MlpDecoders

    def groups(self) -> Groups:
        """Group name -> its tensors (an MLP's in the order w1, b1, w2, b2;
        no tensor for an absent appearance table)."""
        m = self.mlps
        return {
            "anchor": [self.anchor], "offset": [self.offset],
            "feat": [self.feat], "scaling_log": [self.scaling_log],
            "mlp_opacity": list(m.opacity.parameters()),
            "mlp_cov": list(m.cov.parameters()),
            "mlp_color": list(m.color.parameters()),
            "appearance": [] if m.appearance is None else [m.appearance],
        }


class AdamState(NamedTuple):
    mu: Groups
    nu: Groups
    t: int                     # steps taken


def init_adam(params: TrainableParams) -> AdamState:
    groups = params.groups()
    return AdamState(
        mu={k: [torch.zeros_like(p) for p in v] for k, v in groups.items()},
        nu={k: [torch.zeros_like(p) for p in v] for k, v in groups.items()},
        t=0)


def lr_groups(lrs: dict, frozen_mlps: bool = False) -> dict:
    """The per-group LRs of `group_lrs`, with 0 for frozen MLPs (their
    moments are still updated), as the JAX package's `lr_tree`."""
    out = dict(lrs)
    if frozen_mlps:
        out.update({k: 0.0 for k in MLP_GROUPS})
    return out


@torch.no_grad()
def adam_step(params: TrainableParams, grads: Groups, opt_state: AdamState,
              lrs: dict, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15) -> AdamState:
    """One Adam step of every group, in place; returns the state with the
    step count advanced. The bias corrections are computed in float32 and
    every product and quotient is taken in the JAX package's order."""
    t = opt_state.t + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
    for name, ps in params.groups().items():
        if not ps:
            continue
        gs, ms, vs = grads[name], opt_state.mu[name], opt_state.nu[name]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - b2))
        num = torch._foreach_mul(torch._foreach_div(ms, bc1), lrs[name])
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(vs, bc2)), eps)
        torch._foreach_sub_(ps, torch._foreach_div(num, den))
    return opt_state._replace(t=t)
