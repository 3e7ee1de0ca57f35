"""`python -m horizongs_tpu_torch.cli.metrics -m PATH`: PSNR, SSIM and
LPIPS of rendered image sets (the JAX package's `cli/metrics.py`, the
reference's `metrics.py`), on the card (`--device cpu` for the CPU).

Reads the `<PATH>/<set>/ours_*/renders` and `.../gt` PNGs that
`cli.render` or the train CLI wrote and writes
`results_<set>_metrics.json` and `per_view_<set>_metrics.json`. LPIPS is
null without the VGG weights (`train/lpips.py`).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def read_images(renders_dir: str, gt_dir: str):
    """The render PNGs that have a ground-truth PNG of the same name, as
    float32 [0, 1] RGB: (renders, gts, names)."""
    from PIL import Image
    renders, gts, names = [], [], []
    for rp in sorted(glob.glob(os.path.join(renders_dir, "*.png"))):
        name = os.path.basename(rp)
        gp = os.path.join(gt_dir, name)
        if not os.path.exists(gp):
            continue
        renders.append(np.asarray(Image.open(rp).convert("RGB"),
                                  dtype=np.float32) / 255.0)
        gts.append(np.asarray(Image.open(gp).convert("RGB"),
                              dtype=np.float32) / 255.0)
        names.append(name)
    return renders, gts, names


def main(argv=None):
    parser = argparse.ArgumentParser(description="Image-set metrics")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--set", default="test")
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.train.evaluate import (
        evaluate_sets, lpips_fn_or_none)

    device = resolve_device(args.device)
    base = os.path.join(args.model_path, args.set)
    out = {}
    for it_dir in sorted(glob.glob(os.path.join(base, "ours_*"))):
        it = int(it_dir.split("_")[-1])
        renders, gts, _ = read_images(os.path.join(it_dir, "renders"),
                                      os.path.join(it_dir, "gt"))
        if not renders:
            continue
        types = ["aerial"] * len(renders)  # the split is not on disk
        results = evaluate_sets(args.model_path, it, renders, gts, types,
                                lpips_model=lpips_fn_or_none(device),
                                tag=f"{args.set}_metrics", device=device)
        out[f"ours_{it}"] = results
        print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
