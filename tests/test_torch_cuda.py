"""K1 on the card: the CUDA kernel against its plain version, and the
cuda render path against the dense oracle. Skipped without a CUDA device.
The file imports no JAX, so on a GPU machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.data.synthetic import lookat_camera, random_gaussians
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops.raster_cuda import build_raster_inputs
from horizongs_tpu_torch.render import render


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from horizongs_tpu_torch.device import disable_tf32
    disable_tf32()
    return torch.device("cuda")


def _scene(dev, n=2000, seed=3):
    g = random_gaussians(n, seed=seed, extent=0.8, scale_range=(0.02, 0.12))
    g["opacities"][: n // 4] = 0.97          # an opaque front: early stops
    return {k: torch.from_numpy(v).to(dev) for k, v in g.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_kernel_matches_plain(card, size):
    w, h = size
    g = _scene(card)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             w, h)
    args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    before = raster3d.KERNEL.launches
    acc_k, logT_k = raster3d.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert raster3d.KERNEL.launches == before + 1
    acc_p, logT_p = raster3d.rasterize_fwd_plain(*args)
    torch.testing.assert_close(acc_k, acc_p, atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(torch.exp(logT_k[:, 0]),
                               torch.exp(logT_p[:, 0]), atol=1e-4, rtol=0)
    assert (logT_k[:, 1] - logT_p[:, 1]).abs().max() <= 1


@pytest.mark.cuda
def test_cuda_render_matches_dense(card):
    from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    cfg = ModelConfig(voxel_size=0.1, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    pts = random_gaussians(500, seed=0, extent=0.8)["means"]
    state = init_anchor_state_from_points(cfg, pts, device=card)
    gen = torch.Generator().manual_seed(0)
    state = state._replace(
        feat=torch.randn(state.feat.shape, generator=gen).to(card),
        offset=torch.randn(state.offset.shape, generator=gen).to(card))
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=gen, device=card)
    cam = lookat_camera(width=96, height=64, eye=(0.5, -1.0, -3.5),
                        device=card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    with torch.no_grad():
        c = render(cam, cfg, mlps, state, bg, rasterizer="cuda")
        d = render(cam, cfg, mlps, state, bg, rasterizer="dense")
    assert int(c["n_dropped"]) == 0
    assert float(c["render_alphas"].max()) > 0.5
    for key in ("render", "render_alphas"):
        torch.testing.assert_close(c[key], d[key], atol=2e-4, rtol=0)
    torch.testing.assert_close(c["render_depth"], d["render_depth"],
                               atol=2e-4, rtol=2e-4)
    assert np.isfinite(c["render"].cpu().numpy()).all()
