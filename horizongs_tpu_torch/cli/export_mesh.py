"""`python -m horizongs_tpu_torch.cli.export_mesh -m PATH`: TSDF mesh
export of a trained 2DGS model, on the card (`--device cpu` for the CPU).

The JAX package's `cli/export_mesh.py` (the reference's `export_mesh.py`
+ `utils/mesh_utils.py`): render every train view with the 2DGS model
through K3 (SH degree 0, `export_mesh.py:45-46`; the median depth with
`--use_median_depth`), fuse the alpha-masked depth maps into a TSDF
volume sized from the aerial cameras' bounding sphere (a contracted grid
with `--unbounded`), extract, keep the largest cluster and write
`<PATH>/mesh_iteration_<it>.ply`. The instance capacity is calibrated per
resolution from the largest count over its views, so no view drops
instances and each is rendered once.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
from horizongs_tpu_torch.render import count_render_instances, render
from horizongs_tpu_torch.utils.meshing import (
    estimate_bounding_sphere,
    extract_mesh_unbounded,
    fuse_tsdf,
    largest_component,
    marching_tetrahedra,
    write_mesh_ply,
)


@torch.no_grad()
def render_depths(scene, cams, add_prefilter: bool, use_median: bool,
                  rasterizer: str = "cuda"):
    """(depths (H, W), alphas (H, W)) of each camera, tensors on the
    scene's device."""
    mlps = scene.train_state.params.mlps
    state = scene.train_state.anchor_state()
    caps = {}
    for cam in cams:
        key = (cam.height, cam.width)
        n = count_render_instances(cam, scene.cfg, mlps, state,
                                   add_prefilter=add_prefilter)
        caps[key] = max(caps.get(key, 0), n)
    caps = {k: suggest_instance_cap(n, margin=1.15) for k, n in caps.items()}
    depths, alphas = [], []
    for cam in cams:
        pkg = render(cam, scene.cfg, mlps, state, scene.background,
                     add_prefilter=add_prefilter, rasterizer=rasterizer,
                     instance_cap=caps[(cam.height, cam.width)],
                     active_sh_degree=0)
        if int(pkg["n_dropped"]) > 0:
            raise RuntimeError("a view overflowed a capacity calibrated "
                               "from its own count")
        key = ("render_median_depth" if use_median
               and "render_median_depth" in pkg else "render_depth")
        depths.append(pkg[key][..., 0])
        alphas.append(pkg["render_alphas"][..., 0])
    return depths, alphas


def main(argv=None):
    parser = argparse.ArgumentParser(description="TSDF mesh export")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--voxel_size", type=float, default=None)
    parser.add_argument("--sdf_trunc", type=float, default=None)
    parser.add_argument("--depth_trunc", type=float, default=None)
    parser.add_argument("--resolution", type=int, default=128,
                        help="TSDF grid resolution along the largest axis")
    parser.add_argument("--use_median_depth", action="store_true")
    parser.add_argument("--unbounded", action="store_true",
                        help="contracted-space TSDF for unbounded scenes "
                        "(the reference's experimental "
                        "extract_mesh_unbounded, utils/mesh_utils.py:179, "
                        "completed)")
    parser.add_argument("--rasterizer", default="cuda",
                        choices=["cuda", "dense"])
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.cli.common import get_logger, load_config
    from horizongs_tpu_torch.data.scene import Scene
    from horizongs_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    lp, op, pp, cfg = load_config(
        os.path.join(args.model_path, "config.yaml"), args.model_path)
    logger = get_logger("mesh", args.model_path)
    scene = Scene(lp, cfg, load_iteration=args.iteration, logger=logger,
                  device=device)
    cams = scene.get_train_cameras()

    t0 = time.perf_counter()
    depths, alphas = render_depths(scene, cams, pp.add_prefilter,
                                   args.use_median_depth, args.rasterizer)
    viewmats = [c.viewmat for c in cams]
    Ks = [c.K for c in cams]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_render = time.perf_counter() - t0

    aerial = [c.cam_center.cpu().numpy() for c in cams
              if c.image_type == "aerial"]
    centers = np.array(aerial if aerial
                       else [c.cam_center.cpu().numpy() for c in cams])
    center, radius = estimate_bounding_sphere(centers)
    depth_trunc = args.depth_trunc or (radius * 2.0)

    t0 = time.perf_counter()
    if args.unbounded:
        logger.info(f"unbounded TSDF: center={center}, radius={radius:.3f}"
                    f", contracted grid {args.resolution}^3")
        verts, faces = extract_mesh_unbounded(
            depths, alphas, viewmats, Ks, centers,
            resolution=args.resolution, depth_trunc=args.depth_trunc or 1e9,
            device=device)
        t_fuse = None
    else:
        voxel_size = args.voxel_size or (depth_trunc / args.resolution)
        sdf_trunc = args.sdf_trunc or (5.0 * voxel_size)
        half = depth_trunc / 2.0
        origin = center - half
        dims = (int(2 * half / voxel_size),) * 3
        logger.info(f"TSDF: center={center}, voxel={voxel_size:.4f}, "
                    f"dims={dims}, trunc={sdf_trunc:.4f}")
        tsdf, weight = fuse_tsdf(depths, alphas, viewmats, Ks, origin,
                                 voxel_size, dims, sdf_trunc, depth_trunc,
                                 device=device)
        t_fuse = time.perf_counter() - t0
        verts, faces = marching_tetrahedra(tsdf, weight, origin, voxel_size)
        logger.info(f"raw mesh: {verts.shape[0]} verts, "
                    f"{faces.shape[0]} faces")
    verts, faces = largest_component(verts, faces)
    t_extract = time.perf_counter() - t0 - (t_fuse or 0.0)
    out = os.path.join(args.model_path,
                       f"mesh_iteration_{scene.loaded_iter}.ply")
    write_mesh_ply(out, verts, faces)
    logger.info(f"mesh ({verts.shape[0]} verts, {faces.shape[0]} faces) "
                f"-> {out}; render {t_render:.3f} s, fuse "
                f"{'-' if t_fuse is None else f'{t_fuse:.3f} s'}, extract "
                f"{t_extract:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
