"""Losses: L1, gaussian-window SSIM, PSNR and the full assembly.

The JAX package's `train/losses.py` (Horizon-GS `utils/loss_utils.py` and
the loss of `train.py`):

  total = (1-λ_dssim)·L1 + λ_dssim·(1-SSIM)
        + λ_dreg · mean(prod(scaling))                    [selected gaussians]
        + λ_sky_opa · mean(-(1-sky)·log(1-α))
        + λ_opacity_entropy · mean(-α·log α)
        + λ_normal · mean((1 - n·n_depth)·alpha_mask)     [2DGS, gated]
        + λ_dist · mean(distort·alpha_mask)               [2DGS, gated]
        + w_depth(it) · mean(|1/D - invdepth_mono|·mask)  [gated]

Images are HWC float32. The SSIM blur (11x11 gaussian window, σ 1.5, zero
padded borders) is a separable depthwise `conv2d` pair; the JAX package's
bf16x3 banded matmuls are a TPU precision workaround and are not ported.
cuDNN convolutions default to TF32 on the card: the training step turns
TF32 off (`device.disable_tf32()`) so the blur keeps float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def _window(device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """The normalised 1-D gaussian window, built as the JAX package's
    banded blur matrix builds its band (float32 exp over a float norm)."""
    pad = size // 2
    norm = sum(math.exp(-(x * x) / (2 * sigma ** 2))
               for x in range(-pad, pad + 1))
    d = torch.arange(-pad, pad + 1, device=device, dtype=torch.float32)
    return torch.exp(-(d * d) / (2 * sigma ** 2)) / norm


def _blur5(img1: torch.Tensor, img2: torch.Tensor):
    """Gaussian-blur the five SSIM moment images of an HWC pair in one
    separable depthwise convolution. Returns (mu1, mu2, m11, m22, m12)."""
    H, W, C = img1.shape
    X = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                  dim=-1)                                   # (H, W, 5C)
    X = X.permute(2, 0, 1)[None]                            # (1, 5C, H, W)
    win = _window(img1.device)
    k = win.numel()
    n = X.shape[1]
    X = F.conv2d(X, win.view(1, 1, 1, k).expand(n, 1, 1, k),
                 padding=(0, k // 2), groups=n)
    X = F.conv2d(X, win.view(1, 1, k, 1).expand(n, 1, k, 1),
                 padding=(k // 2, 0), groups=n)
    Z = X[0].permute(1, 2, 0)                               # (H, W, 5C)
    return torch.split(Z, C, dim=-1)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Per-pixel SSIM map of an HWC pair (11x11 gaussian window)."""
    mu1, mu2, m11, m22, m12 = _blur5(img1, img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu12
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM over an HWC pair."""
    return torch.mean(ssim_map(img1, img2, c1, c2))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def assemble_loss(opt, render_pkg: dict, gt_image: torch.Tensor,
                  alpha_mask: Optional[torch.Tensor],
                  invdepth_mono: Optional[torch.Tensor],
                  depth_mask: Optional[torch.Tensor],
                  iteration: float, depth_weight: float,
                  render_mode: str):
    """Full training loss. `opt` is the optim-params namespace. Returns
    (loss, aux dict with l1, ssim, depth_l1 and total)."""
    image = render_pkg["render"]
    alpha = render_pkg["render_alphas"]
    if alpha_mask is None:
        alpha_mask = torch.ones_like(image[..., :1])
    image = image * alpha_mask
    gt = gt_image * alpha_mask

    ll1 = l1_loss(image, gt)
    ssim_val = ssim(image, gt)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_val)
    aux = {"l1": ll1, "ssim": ssim_val}

    if getattr(opt, "lambda_dreg", 0.0) > 0:
        scaling = render_pkg["scaling"]
        sel = render_pkg["selection_mask"].float()
        # mean over *selected* gaussians of prod(scaling)
        prod = torch.prod(scaling, dim=-1) * sel
        denom = torch.clamp_min(torch.sum(sel), 1.0)
        loss = loss + opt.lambda_dreg * torch.sum(prod) / denom

    if getattr(opt, "lambda_sky_opa", 0.0) > 0:
        o = torch.clamp(alpha, 1e-6, 1 - 1e-6)
        sky = alpha_mask
        loss = loss + opt.lambda_sky_opa * torch.mean(
            -(1 - sky) * torch.log(1 - o))

    if getattr(opt, "lambda_opacity_entropy", 0.0) > 0:
        o = torch.clamp(alpha, 1e-6, 1 - 1e-6)
        loss = loss + opt.lambda_opacity_entropy * torch.mean(
            -o * torch.log(o))

    if getattr(opt, "lambda_normal", 0.0) > 0 and "render_normals" in render_pkg:
        normals = render_pkg["render_normals"]
        nfd = render_pkg["render_normals_from_depth"] * alpha.detach()
        n_err = 1.0 - torch.sum(normals * nfd, dim=-1, keepdim=True)
        normal_loss = torch.mean(n_err * alpha_mask)
        gate = float(iteration > opt.normal_start_iter)
        loss = loss + opt.lambda_normal * gate * normal_loss

    if getattr(opt, "lambda_dist", 0.0) > 0 and "render_distort" in render_pkg:
        dist_loss = torch.mean(render_pkg["render_distort"] * alpha_mask)
        gate = float(iteration > opt.dist_start_iter)
        loss = loss + opt.lambda_dist * gate * dist_loss

    ll1depth = torch.zeros((), device=image.device)
    if invdepth_mono is not None and render_mode in ("RGB+D", "RGB+ED"):
        rdepth = render_pkg["render_depth"]
        inv = torch.where(rdepth > 0.0,
                          1.0 / torch.clamp_min(rdepth, 1e-8),
                          torch.zeros_like(rdepth))
        dmask = depth_mask if depth_mask is not None else torch.ones_like(inv)
        pure = torch.mean(torch.abs((inv - invdepth_mono) * dmask))
        gate = float(iteration > opt.start_depth)
        ll1depth = depth_weight * gate * pure
        loss = loss + ll1depth

    aux["depth_l1"] = ll1depth
    aux["total"] = loss
    return loss, aux
