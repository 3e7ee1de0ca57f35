"""Render sets and evaluation: the reference's post-training pipeline.

The JAX package's `train/evaluate.py` (`render_sets` / `evaluate`,
`train.py:385-669`): re-render a camera set through the cuda path (the
neural model, or with `explicit=True` the baked one), write renders /
ground truth / error maps, count the visible gaussians per view, and
compute PSNR, SSIM and LPIPS split by aerial/street (and UCGS subset) into
results_<tag>.json and per_view_<tag>.json. LPIPS needs the VGG weights
(`train/lpips.py`); without them the results report it as null.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.models.explicit import (
    count_explicit_instances,
    render_explicit,
)
from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
from horizongs_tpu_torch.render import count_render_instances, render
from horizongs_tpu_torch.train.losses import psnr, ssim
from horizongs_tpu_torch.train.lpips import lpips_fn, weights_path


def save_image(path: str, img, alpha=None) -> None:
    """HWC [0, 1] array or tensor -> 8-bit PNG (RGBA with `alpha`)."""
    from PIL import Image

    def host(a):
        return (a.detach().cpu().numpy() if torch.is_tensor(a)
                else np.asarray(a))
    arr = (np.clip(host(img), 0, 1) * 255).astype(np.uint8)
    if alpha is not None:
        a = (np.clip(host(alpha)[..., 0], 0, 1) * 255).astype(np.uint8)
        arr = np.concatenate([arr, a[..., None]], axis=-1)
        Image.fromarray(arr, "RGBA").save(path)
    else:
        Image.fromarray(arr).save(path)


def lpips_fn_or_none(device: DeviceLike = None):
    """The LPIPS(vgg) scorer on `device` (the card by default) when its
    weights are on the machine; else a warning and None. Unlike the JAX
    package this does not fall back to the `lpips` pip package, which
    downloads its weights."""
    fn = lpips_fn(device=device)
    if fn is None:
        print(f"WARNING: LPIPS unavailable (no VGG weights at "
              f"{weights_path()}; convert them with "
              f"tools/convert_lpips_weights.py) — results.json will report "
              f"LPIPS: null.", file=sys.stderr, flush=True)
    return fn


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def render_set(out_dir: str, name: str, iteration: int, cameras, cfg,
               scene, state, rasterizer: str = "cuda",
               save_images: bool = True, explicit: bool = False,
               add_prefilter: Optional[bool] = None):
    """Render one camera set; returns (renders, gts, per-view visible
    counts, seconds per view, image types, evaluation subset tags), the
    images as numpy arrays. `state` is a `TrainState`, or with
    `explicit=True` an `ExplicitState` (the baked model, rendered at the
    configuration's SH degree; a view counts its LOD-gated gaussians).

    The instance capacity is calibrated per resolution (the first view's
    count x 1.5); a view that overflows it is recalibrated from itself and
    rendered again, so nothing is ever dropped. `add_prefilter=None`
    defaults to the scene's flag; the train CLI passes
    `not (no_prefilter_step > 0)`, as the reference's `render_sets`
    (`train.py:478-484`). The explicit model has no prefilter."""
    base = os.path.join(out_dir, name, f"ours_{iteration}")
    render_dir = os.path.join(base, "renders")
    gt_dir = os.path.join(base, "gt")
    err_dir = os.path.join(base, "errors")
    if save_images:
        for d in (render_dir, gt_dir, err_dir):
            os.makedirs(d, exist_ok=True)
    if add_prefilter is None:
        add_prefilter = getattr(scene, "add_prefilter", True)
    if explicit:
        dev = state.xyz.device

        def count(cam):
            return count_explicit_instances(cam, cfg, state)

        def draw(cam, cap):
            return render_explicit(cam, cfg, state, scene.background,
                                   rasterizer=rasterizer, instance_cap=cap)
        visible = "gs_mask"
    else:
        mlps, astate = state.params.mlps, state.anchor_state()
        dev = astate.anchor.device

        def count(cam):
            return count_render_instances(cam, cfg, mlps, astate,
                                          add_prefilter=add_prefilter)

        def draw(cam, cap):
            return render(cam, cfg, mlps, astate, scene.background,
                          add_prefilter=add_prefilter, rasterizer=rasterizer,
                          instance_cap=cap)
        visible = "selection_mask"

    def calibrate(cam):
        return suggest_instance_cap(count(cam), margin=1.5)

    renders, gts, counts, times, types, subsets = [], [], [], [], [], []
    caps = {}
    for idx, cam in enumerate(cameras):
        key = (cam.height, cam.width)
        if key not in caps:
            caps[key] = calibrate(cam)
        t0 = time.perf_counter()
        pkg = draw(cam, caps[key])
        while int(pkg["n_dropped"]) > 0:
            # this view overflowed the calibrated capacity: recalibrate
            # from it and render again; evaluation never drops instances
            caps[key] = calibrate(cam)
            pkg = draw(cam, caps[key])
        img = pkg["render"]
        _sync(dev)
        times.append(time.perf_counter() - t0)
        counts.append(int(pkg[visible].sum()))
        gt = cam.image if cam.image is not None else torch.zeros_like(img)
        mask = cam.alpha_mask
        if mask is not None:
            img = img * mask
            gt = gt * mask
        img, gt = img.cpu().numpy(), gt.cpu().numpy()
        renders.append(img)
        gts.append(gt)
        types.append(cam.image_type)
        subsets.append(cam.subset)
        if save_images:
            stem = f"{idx:05d}"
            save_image(os.path.join(render_dir, stem + ".png"), img,
                       alpha=mask)
            save_image(os.path.join(gt_dir, stem + ".png"), gt, alpha=mask)
            save_image(os.path.join(err_dir, stem + ".png"),
                       np.abs(img - gt))
    if save_images:
        with open(os.path.join(base, "per_view_count.json"), "w") as f:
            json.dump({f"{i:05d}": c for i, c in enumerate(counts)}, f)
    return renders, gts, counts, times, types, subsets


def evaluate_sets(out_dir: str, iteration: int, renders, gts, types,
                  lpips_model=None, tag: str = "test", subsets=None,
                  device: DeviceLike = None):
    """PSNR/SSIM(/LPIPS) per aerial/street split -> results_<tag>.json
    (`metrics.py:52-148`, `train.py:520-669`), PSNR and SSIM computed on
    `device` (the card when None, as `device.resolve_device` rules). Non-empty `subsets` tags (UCGS's held-out / +0.1m /
    +0.1m+5° splits, `train.py:542-591`) each form a group of their own
    beside aerial/street."""
    device = resolve_device(device)
    per_view = {"PSNR": {}, "SSIM": {}, "LPIPS": {}}
    groups = {"all": [], "aerial": [], "street": []}
    if subsets is None:
        subsets = [""] * len(renders)
    for sub in subsets:
        if sub and sub not in groups:
            groups[sub] = []
    with torch.no_grad():
        for i, (r, g, t, sub) in enumerate(zip(renders, gts, types,
                                               subsets)):
            rt = torch.from_numpy(r).to(device)
            gt = torch.from_numpy(g).to(device)
            p = float(psnr(rt, gt))
            s = float(ssim(rt, gt))
            lp = None
            if lpips_model is not None:
                lp = float(lpips_model(r, g))
            name = f"{i:05d}"
            per_view["PSNR"][name] = p
            per_view["SSIM"][name] = s
            per_view["LPIPS"][name] = lp
            groups["all"].append((p, s, lp))
            groups[t].append((p, s, lp))
            if sub:
                groups[sub].append((p, s, lp))

    results = {}
    for gname, vals in groups.items():
        if not vals:
            continue
        results[gname] = {
            "PSNR": float(np.mean([v[0] for v in vals])),
            "SSIM": float(np.mean([v[1] for v in vals])),
            "LPIPS": (float(np.mean([v[2] for v in vals]))
                      if vals[0][2] is not None else None),
            "n_views": len(vals),
        }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"results_{tag}.json"), "w") as f:
            json.dump({f"ours_{iteration}": results}, f, indent=2)
        with open(os.path.join(out_dir, f"per_view_{tag}.json"), "w") as f:
            json.dump({f"ours_{iteration}": per_view}, f, indent=2)
    return results
