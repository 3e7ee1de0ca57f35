"""`ops/project3d.project_fields_3dgs` on the CPU: CPU tensors take the
plain path (the projection, the cull and the packing as before, bit for
bit, binning on the field columns as before on the projection's outputs),
counted in `render.project_rows` and not in `render.project_rows_card`;
the span `render.project` under `render.bin` on the 3DGS and the 2DGS
paths; a camera that requires a gradient refused; and the card's checks
(float32, contiguous, one device, the shapes) refusing what P1 does not
take. The kernels themselves are held to the plain path on the card in
`test_torch_project_cuda.py`."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.data.synthetic import (
    lookat_camera,
    orbit_cameras,
    random_gaussians,
)
from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import init_mlps
from horizongs_tpu_torch.ops import project3d
from horizongs_tpu_torch.ops.binning import (
    build_tile_instances,
    count_tile_instances,
)
from horizongs_tpu_torch.ops.projection import project_3dgs
from horizongs_tpu_torch.ops.raster import _make_grid
from horizongs_tpu_torch.ops.raster3d import TILE_H, TILE_W
from horizongs_tpu_torch.ops.raster_cuda import (
    build_raster_inputs,
    count_instances_3dgs,
)
from horizongs_tpu_torch.ops.raster_fields import pack_fields_3dgs
from horizongs_tpu_torch.render import render

torch.set_num_threads(1)

W, H = 64, 48


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _rows(n=500, seed=0):
    """Splats around a camera at (0, 0, -4), with rows behind the near
    plane, off the image and below the alpha cutoff."""
    g = random_gaussians(n, seed=seed, extent=1.2, scale_range=(0.02, 0.3))
    rng = np.random.default_rng(seed)
    g["means"][:40, 2] = rng.uniform(-4.3, -3.99, 40).astype(np.float32)
    g["means"][40:80, 0] = rng.uniform(6.0, 9.0, 40).astype(np.float32)
    g["opacities"][80:120] = rng.uniform(0, 1 / 255, 40).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in g.items()}


def _camera():
    return lookat_camera(width=W, height=H, eye=(0, 0, -4), device="cpu")


def _old_packing(g, cam, probe=None):
    """The packing as `build_raster_inputs` wrote it before the step."""
    proj = project_3dgs(g["means"], g["quats"], g["scales"], cam.viewmat,
                        cam.K, W, H)
    cull = project3d._cull_radii(proj, g["opacities"])
    means2d = proj.means2d if probe is None else proj.means2d + probe
    fields = torch.cat([means2d, proj.conics, g["opacities"][:, None],
                        g["colors"], proj.depths[:, None]], dim=-1)
    return proj, cull, fields


@pytest.mark.parametrize("with_probe", [False, True])
def test_cpu_takes_the_plain_path_bit_for_bit(with_probe):
    g, cam = _rows(), _camera()
    n = g["means"].shape[0]
    probe = (torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 2)).astype(np.float32)) if with_probe else None)
    project3d.KERNEL.launches = 0
    with profile(activities=[ProfilerActivity.CPU]):
        pf = project3d.project_fields_3dgs(
            g["means"], g["quats"], g["scales"], g["opacities"],
            lambda: g["colors"], cam.viewmat, cam.K, W, H, probe)
    proj, cull, fields = _old_packing(g, cam, probe)
    assert pf.fields.is_contiguous() and pf.fields.shape == (n, 10)
    assert torch.equal(pf.fields, fields)
    assert torch.equal(pf.radii, proj.radii)
    assert torch.equal(pf.cull, cull)
    assert project3d.KERNEL.launches == 0
    counters = tracing.snapshot()["counters"]
    assert counters["render.project_rows"] == [n]
    assert counters["render.project_rows_card"] == [0]
    # the culls were there
    assert (pf.radii[:40] == 0).all() and (pf.radii[40:80] == 0).all()
    assert (pf.cull[80:120] == 0).all() and (pf.radii[120:] > 0).any()


def test_proj_views_the_field_columns():
    g, cam = _rows(), _camera()
    pf = project3d.project_fields_3dgs(
        g["means"], g["quats"], g["scales"], g["opacities"],
        lambda: g["colors"], cam.viewmat, cam.K, W, H)
    p = pf.proj
    for col, x in ((slice(0, 2), p.means2d), (slice(2, 5), p.conics),
                   (9, p.depths)):
        assert x.data_ptr() == pf.fields[:, col].data_ptr()
        assert torch.equal(x, pf.fields[:, col])
    assert p.radii is pf.radii


def test_a_colour_function_runs_after_the_projection():
    """The colour function gives the same fields, and on the plain path
    runs once the projection is built (its nodes follow the
    projection's)."""
    g, cam = _rows(), _camera()
    seen = []

    def colours():
        seen.append(len(tracing.snapshot()["spans"]))
        return g["colors"]
    with profile(activities=[ProfilerActivity.CPU]):
        pf = project3d.project_fields_3dgs(
            g["means"], g["quats"], g["scales"], g["opacities"], colours,
            cam.viewmat, cam.K, W, H)
    assert seen == [1]          # `render.project` had closed
    assert torch.equal(pf.fields, _old_packing(g, cam)[2])


def test_no_colour_gives_zero_colour_columns():
    g, cam = _rows(), _camera()
    pf = project3d.project_fields_3dgs(
        g["means"], g["quats"], g["scales"], g["opacities"], None,
        cam.viewmat, cam.K, W, H)
    assert (pf.fields[:, 6:9] == 0).all()
    assert torch.equal(pf.fields[:, 5], g["opacities"])


def test_binning_and_counts_as_before():
    """Binning on the field columns enumerates the instances it did on
    the projection's own outputs, and the count agrees with it."""
    g, cam = _rows(), _camera()
    probe = torch.zeros((g["means"].shape[0], 2), requires_grad=True)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat,
                             cam.K, W, H, means2d_probe=probe)
    proj, cull, fields = _old_packing(g, cam, probe)
    grid = _make_grid(W, H, TILE_W, TILE_H)
    old = build_tile_instances(
        proj.means2d.detach(), cull, proj.depths, grid.n_tiles_x,
        grid.n_tiles_y, TILE_W, TILE_H, ri.inst.gauss_id.shape[0],
        conics=proj.conics, opacities=g["opacities"])
    for name in ("gauss_id", "tile_id", "n_instances", "tile_starts"):
        assert torch.equal(getattr(ri.inst, name), getattr(old, name)), name
    assert torch.equal(ri.fields, fields)
    assert int(ri.inst.n_instances) > 0
    n = count_instances_3dgs(g["means"], g["quats"], g["scales"],
                             g["opacities"], cam.viewmat, cam.K, W, H)
    assert int(n) == int(count_tile_instances(
        proj.means2d, cull, grid.n_tiles_x, grid.n_tiles_y, TILE_W, TILE_H,
        conics=proj.conics, opacities=g["opacities"]))
    assert int(n) >= int(ri.inst.n_instances)
    # the probe's gradient is the fields' screen-space gradient
    (ri.fields[:, 0:2] * torch.arange(2.0)).sum().backward()
    assert torch.equal(probe.grad, torch.arange(2.0).expand_as(probe.grad))


def test_pack_fields_3dgs_returns_the_cull_and_views():
    g, cam = _rows(), _camera()
    fields, radii, proj = pack_fields_3dgs(
        g["means"], g["quats"], g["scales"], g["opacities"], g["colors"],
        cam.viewmat, cam.K, W, H)
    old_proj, cull, old_fields = _old_packing(g, cam)
    assert torch.equal(fields, old_fields)
    assert torch.equal(radii, cull)
    assert torch.equal(proj.radii, old_proj.radii)
    assert torch.equal(proj.conics, old_proj.conics)


def _model(gs_attr):
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=8, n_offsets=4,
                      view_dim=3, voxel_size=0.3, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0,
                      render_mode="RGB+ED", gs_attr=gs_attr)
    pts = random_gaussians(300, seed=1, extent=1.0)["means"]
    state = init_anchor_state_from_points(cfg, pts, device="cpu")
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    return cfg, state, mlps


@pytest.mark.parametrize("gs_attr", ["3D", "2D"])
def test_project_span_under_bin(gs_attr):
    """`render.project` inside `render.bin` on both paths, once a render,
    its rows counted and none on the card."""
    cfg, state, mlps = _model(gs_attr)
    cam = orbit_cameras(3, width=32, height=32, device="cpu")[1]
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            render(cam, cfg, mlps, state, torch.zeros(3))
    snap = tracing.snapshot()
    spans = [sp for sp in snap["spans"] if sp["name"] == "render.project"]
    assert [sp["parent"] for sp in spans] == ["render.bin"]
    assert spans[0]["host_ms"] > 0
    assert snap["counters"]["render.project_rows"] == [
        state.capacity * cfg.n_offsets]
    assert snap["counters"]["render.project_rows_card"] == [0]


@pytest.mark.parametrize("which", ["viewmat", "K"])
def test_refuses_a_camera_that_requires_grad(which):
    g, cam = _rows(), _camera()
    cam_t = {"viewmat": cam.viewmat.clone(), "K": cam.K.clone()}
    cam_t[which].requires_grad_(True)
    with pytest.raises(ValueError, match="viewmat or K"):
        project3d.project_fields_3dgs(
            g["means"], g["quats"], g["scales"], g["opacities"],
            lambda: g["colors"], cam_t["viewmat"], cam_t["K"], W, H)


def _card_args(n=16):
    return {"means": torch.zeros(n, 3), "quats": torch.zeros(n, 4),
            "scales": torch.ones(n, 3), "opacities": torch.ones(n),
            "rgb": torch.zeros(n, 3), "probe": torch.zeros(n, 2),
            "viewmat": torch.eye(4), "K": torch.eye(3)}


BAD = {
    "means_strided": ("means", lambda n: torch.zeros(3, n).t(),
                      "contiguous"),
    "quats_shape": ("quats", lambda n: torch.zeros(n, 3), r"\(16, 4\)"),
    "scales_dtype": ("scales", lambda n: torch.ones(n, 3,
                                                    dtype=torch.float64),
                     "float32"),
    "opacities_strided": ("opacities", lambda n: torch.ones(n, 2)[:, 0],
                          "contiguous"),
    "rgb_strided": ("rgb", lambda n: torch.zeros(n, 10)[:, 6:9],
                    "contiguous"),
    "probe_shape": ("probe", lambda n: torch.zeros(n), r"\(16, 2\)"),
    "viewmat_strided": ("viewmat", lambda n: torch.eye(4).t(), "contiguous"),
    "K_shape": ("K", lambda n: torch.eye(4), r"\(3, 3\)"),
}


def test_card_checks_pass_good_inputs():
    a = _card_args()
    project3d._check_card(*a.values())
    project3d._check_card(*{**a, "rgb": None, "probe": None}.values())


@pytest.mark.parametrize("case", sorted(BAD))
def test_card_checks_refuse(case):
    """What the wrapper checks before P1's launch on the card (held here
    on CPU tensors: the checks do not depend on the device)."""
    name, make, msg = BAD[case]
    a = _card_args()
    a[name] = make(16)
    with pytest.raises(ValueError, match=msg):
        project3d._check_card(*a.values())
