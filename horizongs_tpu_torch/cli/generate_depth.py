"""`python -m horizongs_tpu_torch.cli.generate_depth -s PATH` — mono-depth maps.

The JAX package's `cli/generate_depth.py`. Reference equivalent:
`preprocess/generate_depth.py` (runs DPT / Depth-Anything-V2 over every
training image and saves inverse-depth .npy/.png maps) +
`preprocess/make_depth_scale.py` (fits a per-image scale/offset of the
mono inverse depth against COLMAP sparse depth by median/MAD,
`make_depth_scale.py:60-76`).

The depth network is an external pretrained model, and this CLI uses only
weights already on the machine. Two backends, both optional:
  * --backend torchhub: `torch.hub` DPT (intel-isl/MiDaS) from the hub
    cache (`torch.hub.get_dir()`), on the card unless `--device cpu`;
    nothing is downloaded
  * --backend onnx: a local ONNX file via onnxruntime (--model PATH)
Without the weights either exits 2. The scale/offset fit (`--fit-scales`)
is host numpy, needs only the COLMAP model and the generated maps — no
network, no device — and writes `depth_params.json` in the sparse model
dir, which the COLMAP reader consumes (`data/readers.py` depth_params
handling).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _iter_images(images_dir):
    exts = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")
    for root, _, files in os.walk(images_dir):
        for f in sorted(files):
            if f.endswith(exts):
                yield os.path.join(root, f)


def _load_rgb(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0


def _save_invdepth(out_base, inv):
    np.save(out_base + ".npy", inv.astype(np.float32))


def _load_cached_hub(name: str):
    """`torch.hub.load` of intel-isl/MiDaS's `name` from the hub cache
    only: the repository must be there already, and a weight download
    raises instead of reaching the network."""
    import torch
    repo = os.path.join(torch.hub.get_dir(), "intel-isl_MiDaS_master")
    if not os.path.isdir(repo):
        raise FileNotFoundError(f"no cached MiDaS repository at {repo}")

    def no_download(url, *args, **kwargs):
        raise FileNotFoundError(f"weights not in the hub cache: {url}")
    download = torch.hub.download_url_to_file
    torch.hub.download_url_to_file = no_download
    try:
        return torch.hub.load(repo, name, source="local")
    finally:
        torch.hub.download_url_to_file = download


def run_torchhub(args, images):
    import torch
    from horizongs_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    model = _load_cached_hub(args.hub_model).to(device)
    model.eval()
    transforms = _load_cached_hub("transforms")
    tf = (transforms.dpt_transform if "DPT" in args.hub_model
          else transforms.small_transform)
    for path in images:
        rgb = (_load_rgb(path) * 255).astype(np.uint8)
        batch = tf(rgb).to(device)
        with torch.no_grad():
            pred = model(batch)
            pred = torch.nn.functional.interpolate(
                pred.unsqueeze(1), size=rgb.shape[:2], mode="bicubic",
                align_corners=False).squeeze()
        rel = os.path.splitext(os.path.relpath(path, args.images_dir))[0]
        out_base = os.path.join(args.out_dir, rel)
        os.makedirs(os.path.dirname(out_base), exist_ok=True)
        _save_invdepth(out_base, pred.cpu().numpy())
        print(f"depth: {rel}")


def run_onnx(args, images):
    import onnxruntime as ort
    sess = ort.InferenceSession(args.model)
    iname = sess.get_inputs()[0].name
    ih, iw = sess.get_inputs()[0].shape[-2:]
    for path in images:
        rgb = _load_rgb(path)
        h, w = rgb.shape[:2]
        from PIL import Image
        small = np.asarray(Image.fromarray(
            (rgb * 255).astype(np.uint8)).resize((iw, ih))) / 255.0
        x = small.astype(np.float32).transpose(2, 0, 1)[None]
        pred = sess.run(None, {iname: x})[0].squeeze()
        inv = np.asarray(Image.fromarray(pred).resize((w, h)))
        rel = os.path.splitext(os.path.relpath(path, args.images_dir))[0]
        out_base = os.path.join(args.out_dir, rel)
        os.makedirs(os.path.dirname(out_base), exist_ok=True)
        _save_invdepth(out_base, inv)
        print(f"depth: {rel}")


def fit_scales(args):
    """Per-image (scale, offset) of mono inverse depth vs COLMAP sparse
    depth (reference `make_depth_scale.py:60-76`); writes
    depth_params.json next to the sparse model."""
    from horizongs_tpu_torch.data.colmap import (
        qvec2rotmat, read_images_binary, read_points3D_binary_full)
    from horizongs_tpu_torch.data.depth_tools import (
        fit_invdepth_scale, sparse_depths_for_image)

    sparse = os.path.join(args.source, "sparse", "0")
    images = read_images_binary(os.path.join(sparse, "images.bin"))
    ids, xyz, _rgb, _err = read_points3D_binary_full(
        os.path.join(sparse, "points3D.bin"))

    params = {}
    for img in images.values():
        name = os.path.splitext(img.name)[0]
        depth_path = os.path.join(args.out_dir, name + ".npy")
        if not os.path.exists(depth_path):
            continue
        mono = np.load(depth_path)
        viewmat = np.eye(4)
        viewmat[:3, :3] = qvec2rotmat(img.qvec)
        viewmat[:3, 3] = img.tvec
        uvs, depths = sparse_depths_for_image(
            img.xys, img.point3D_ids, xyz, ids, viewmat)
        if len(depths) < 10:
            continue
        fit = fit_invdepth_scale(mono, uvs, depths)
        params[name] = {"scale": fit["scale"], "offset": fit["offset"]}
        print(f"fit: {name} scale={fit['scale']:.5f} "
              f"offset={fit['offset']:.5f} (n={fit['n']})")

    out = os.path.join(sparse, "depth_params.json")
    with open(out, "w") as f:
        json.dump(params, f, indent=1)
    print(f"wrote {out} ({len(params)} images)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-s", "--source", required=True,
                    help="dataset root (COLMAP layout)")
    ap.add_argument("--images-dir", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--backend", choices=["torchhub", "onnx"],
                    default="torchhub")
    ap.add_argument("--hub-model", default="DPT_Large")
    ap.add_argument("--model", default=None, help="ONNX model path")
    ap.add_argument("--device", default=None,
                    help="where the torchhub network runs: the card when "
                    "omitted (raises without one), or cpu")
    ap.add_argument("--fit-scales", action="store_true",
                    help="only fit scale/offset of existing maps")
    args = ap.parse_args(argv)

    args.images_dir = args.images_dir or os.path.join(args.source, "images")
    args.out_dir = args.out_dir or os.path.join(args.source, "depths")

    if args.fit_scales:
        fit_scales(args)
        return 0

    images = list(_iter_images(args.images_dir))
    if not images:
        print(f"no images under {args.images_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    try:
        if args.backend == "torchhub":
            run_torchhub(args, images)
        else:
            if not args.model:
                print("--backend onnx requires --model", file=sys.stderr)
                return 1
            run_onnx(args, images)
    except Exception as e:  # zero-egress: weights not downloadable
        print(f"depth backend unavailable: {e}\n"
              "Provide cached torch-hub weights or a local --model ONNX "
              "file; then re-run. The rest of the pipeline (training "
              "without depth loss) does not require depth maps.",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
