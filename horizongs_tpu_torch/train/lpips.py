"""LPIPS (VGG-16) as a PyTorch module, the counterpart of the JAX
package's `train/lpips_jax.py` (the reference's vendored
`lpipsPyTorch/`, loaded at `train.py:50` and `metrics.py:151`).

Images in [-1, 1] pass a fixed shift/scale normalisation, run through the
VGG-16 feature stack, and the five tap activations (relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3) are unit-normalised over channels; their
squared differences are weighted by the learned 1x1 "linear" weights,
averaged over space and summed over the taps.

The pretrained weights cannot be downloaded, so they load from the JAX
package's npz (`tools/convert_lpips_weights.py` writes it once on a
machine with torchvision and the `lpips` pip package): an explicit path,
else $HGS_LPIPS_WEIGHTS, else ~/.cache/horizongs_tpu/lpips_vgg.npz. One
file serves both packages. Its schema: `conv{i}_w` (kh, kw, cin, cout)
and `conv{i}_b` for the 13 convolutions in order, and `lin{j}_w` (C_j,)
for the 5 taps; the kernels become (cout, cin, kh, kw) for `F.conv2d`
as they load. `lpips_fn` returns a scorer, or None when there are no
weights.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horizongs_tpu_torch.device import DeviceLike, resolve_device

# VGG-16 feature stack: channel widths, "M" = 2x2 max pool. The taps are
# the relu activations just before each pool and the last relu.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
TAP_AFTER_CONV = (1, 3, 6, 9, 12)   # 0-based indices of the tap convs
TAP_CHANNELS = (64, 128, 256, 512, 512)

# the LPIPS input scaling layer (images come in as [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "horizongs_tpu", "lpips_vgg.npz")


def init_random_weights(seed: int = 0) -> dict:
    """Random weights of the right shapes, the JAX package's for the same
    seed: for shape and pipeline checks only, the scores mean nothing."""
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    i = 0
    for v in VGG16_CFG:
        if v == "M":
            continue
        params[f"conv{i}_w"] = rng.normal(
            0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, v)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros(v, dtype=np.float32)
        cin = v
        i += 1
    for j, c in enumerate(TAP_CHANNELS):
        params[f"lin{j}_w"] = rng.uniform(0, 0.01, c).astype(np.float32)
    return params


def weights_path(path: Optional[str] = None) -> str:
    return path or os.environ.get("HGS_LPIPS_WEIGHTS") or DEFAULT_CACHE


def load_weights(path: Optional[str] = None) -> Optional[dict]:
    """The npz's arrays (HWIO kernels, as written), or None without one."""
    path = weights_path(path)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class LPIPS(nn.Module):
    """The scorer's network; `params` in the npz schema."""

    def __init__(self, params: dict):
        super().__init__()
        n_conv = sum(v != "M" for v in VGG16_CFG)
        # HWIO -> OIHW
        self.conv_w = nn.ParameterList(
            torch.from_numpy(np.ascontiguousarray(
                np.asarray(params[f"conv{i}_w"], np.float32)
                .transpose(3, 2, 0, 1))) for i in range(n_conv))
        self.conv_b = nn.ParameterList(
            torch.from_numpy(np.asarray(params[f"conv{i}_b"], np.float32))
            for i in range(n_conv))
        self.lin_w = nn.ParameterList(
            torch.from_numpy(np.asarray(params[f"lin{j}_w"], np.float32))
            for j in range(len(TAP_CHANNELS)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[:, None, None])
        self.requires_grad_(False)

    def taps(self, x: torch.Tensor) -> list:
        """x (N, 3, H, W), normalised -> the 5 tap activations."""
        taps = []
        i = 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = torch.relu(F.conv2d(x, self.conv_w[i], self.conv_b[i],
                                    padding=1))
            if i in TAP_AFTER_CONV:
                taps.append(x)
            i += 1
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor
                ) -> torch.Tensor:
        """img0, img1 (N, 3, H, W) in [-1, 1] -> (N,) distances."""
        t0 = self.taps((img0 - self.shift) / self.scale)
        t1 = self.taps((img1 - self.shift) / self.scale)
        total = 0.0
        for w, a, b in zip(self.lin_w, t0, t1):
            na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d2 = (na - nb) ** 2
            total = total + (d2 * w[:, None, None]).sum(1).mean((1, 2))
        return total


def lpips_distance(params: dict, img0: torch.Tensor,
                   img1: torch.Tensor) -> torch.Tensor:
    """img0, img1 (N, H, W, 3) in [-1, 1] -> (N,) distances, the JAX
    package's `lpips_distance` on NHWC images."""
    net = LPIPS(params).to(img0.device)
    return net(img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2))


def lpips_fn(path: Optional[str] = None, params: Optional[dict] = None,
             device: DeviceLike = None):
    """(img0, img1) -> float scorer of [0, 1] HWC images (numpy arrays or
    tensors), on `device` (the card by default), or None when there are no
    weights."""
    params = params if params is not None else load_weights(path)
    if params is None:
        return None
    dev = resolve_device(device)
    net = LPIPS(params).to(dev)

    @torch.no_grad()
    def score(img0, img1) -> float:
        a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                .permute(2, 0, 1)[None] * 2.0 - 1.0 for x in (img0, img1))
        return float(net(a, b)[0])

    return score
