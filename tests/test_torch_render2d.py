"""Port parity, the 2DGS slice: `render()` of the flagship LOD model as
surfels (`gs_attr="2D"`) against the JAX package's Pallas path (interpret
mode) and dense oracle, with the JAX weights carried across by
`convert.py` (the models of `test_torch_render.py`).

Tolerances as `tests/test_raster2d_pallas.py`: images atol 2e-4, alphas
2e-5, normals 2e-4, normals from depth 5e-4, distortion 5e-4 and median
depth 1e-4, with rtol 2e-4 on the depth-valued outputs (ED depth,
distortion, median): the two packages' decodes and projections differ by
ulps, which depth-sized values carry.

The reference's 2DGS binning tests a tile against the circle of radius
max(AABB half extents) of a surfel's cut-off disk, which misses the ends of
a disk seen tilted along a diagonal (they reach sqrt(hx² + hy²)). So on the
flagship with offset noise the JAX package's own Pallas path and dense
oracle differ by about 3e-3 (`test_reference_binning_misses_tilted_disks`),
and the port's cuda path is held to the dense oracle with every visible
surfel binned into every tile."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from horizongs_tpu.render import count_render_instances as j_count
from horizongs_tpu.render import render as j_render
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.ops import raster_cuda
from horizongs_tpu_torch.render import count_render_instances as t_count
from horizongs_tpu_torch.render import render as t_render
from test_torch_render import _models

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

# (key, atol, rtol) of each compared output
OUTPUTS = (("render", 2e-4, 0.0), ("render_alphas", 2e-5, 0.0),
           ("render_depth", 1e-4, 2e-4), ("render_normals", 2e-4, 0.0),
           ("render_normals_from_depth", 5e-4, 0.0),
           ("render_distort", 5e-4, 2e-4),
           ("render_median_depth", 1e-4, 2e-4))
BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(scope="module")
def flagship():
    cfg, ts, cams = _flagship()
    return cfg, ts, cams[0]


def _models2d(flagship, offset_noise: bool):
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _models(flagship,
                                                        offset_noise)
    return ((dataclasses.replace(cfg, gs_attr="2D"), jm, js, jcam),
            (ModelConfig(**{**tcfg.__dict__, "gs_attr": "2D"}), tm, ts,
             tcam))


def _assert_pkgs_close(tp, jp, what):
    for key, atol, rtol in OUTPUTS:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {key}")


@pytest.mark.parametrize("offset_noise, prefilter",
                         [(True, True), (False, True), (True, False)],
                         ids=["offset_noise-prefilter",
                              "zero_offsets-prefilter",
                              "offset_noise-no_prefilter"])
def test_render_2d_matches_pallas(flagship, offset_noise, prefilter):
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _models2d(flagship,
                                                          offset_noise)
    n_j = int(j_count(jcam, cfg, jm, js, add_prefilter=prefilter))
    n_t = t_count(tcam, tcfg, tm, ts, add_prefilter=prefilter)
    assert n_t == n_j > 0
    jp = j_render(jcam, cfg, jm, js, jnp.asarray(BG),
                  add_prefilter=prefilter, rasterizer="pallas_interpret")
    with torch.no_grad():
        tp = t_render(tcam, tcfg, tm, ts, torch.from_numpy(BG),
                      add_prefilter=prefilter, rasterizer="cuda")
    assert set(tp) == set(jp)
    assert int(tp["n_dropped"]) == int(jp["n_dropped"]) == 0
    assert int(tp["n_instances"]) == int(jp["n_instances"]) == n_j
    np.testing.assert_array_equal(tp["visible_mask"].numpy(),
                                  np.asarray(jp["visible_mask"]))
    np.testing.assert_array_equal(tp["radii"].numpy(), np.asarray(jp["radii"]))
    _assert_pkgs_close(tp, jp, "pallas")
    assert float(jp["render_alphas"].max()) > 0.5   # the model is visible
    assert float(jp["render_median_depth"].max()) > 0


def test_dense_2d_matches_jax_dense(flagship):
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _models2d(flagship, True)
    jd = j_render(jcam, cfg, jm, js, jnp.asarray(BG), rasterizer="dense")
    with torch.no_grad():
        td = t_render(tcam, tcfg, tm, ts, torch.from_numpy(BG),
                      rasterizer="dense")
    assert set(td) == set(jd)
    _assert_pkgs_close(td, jd, "dense")


def _bin_everywhere(monkeypatch):
    """Every visible surfel into every tile: a lossless binning."""
    cull = raster_cuda._cull_radii

    def everywhere(proj, opacities, guard_px=0.0):
        r = cull(proj, opacities, guard_px)
        return torch.where(r > 0, torch.full_like(r, 1e6), r)

    monkeypatch.setattr(raster_cuda, "_cull_radii", everywhere)


@pytest.mark.parametrize("offset_noise", [True, False],
                         ids=["offset_noise", "zero_offsets"])
def test_cuda_path_matches_dense(flagship, monkeypatch, offset_noise):
    """With every visible surfel binned into every tile, the cuda path
    (binning, plain K3, image assembly, normals from depth) is the dense
    oracle's function."""
    _, (tcfg, tm, ts, tcam) = _models2d(flagship, offset_noise)
    bg = torch.from_numpy(BG)
    with torch.no_grad():
        d = t_render(tcam, tcfg, tm, ts, bg, rasterizer="dense")
        _bin_everywhere(monkeypatch)
        n_all = t_count(tcam, tcfg, tm, ts)
        c = t_render(tcam, tcfg, tm, ts, bg, rasterizer="cuda",
                     instance_cap=n_all)
    assert int(c["n_dropped"]) == 0
    for key, atol, rtol in OUTPUTS:
        torch.testing.assert_close(c[key], d[key], atol=atol, rtol=rtol,
                                   msg=key)


def test_reference_binning_misses_tilted_disks(flagship):
    """The reference's 2DGS binning is not lossless: on this scene the JAX
    package's Pallas path and its dense oracle differ by more than 1e-3
    (tilted disks reach past the circle of their AABB's larger half
    extent), and the port's cuda path follows the Pallas path, not the
    oracle."""
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _models2d(flagship, True)
    jp = j_render(jcam, cfg, jm, js, jnp.asarray(BG),
                  rasterizer="pallas_interpret")
    jd = j_render(jcam, cfg, jm, js, jnp.asarray(BG), rasterizer="dense")
    gap = np.abs(np.asarray(jp["render"]) - np.asarray(jd["render"])).max()
    assert gap > 1e-3
    with torch.no_grad():
        tp = t_render(tcam, tcfg, tm, ts, torch.from_numpy(BG),
                      rasterizer="cuda")
    assert np.abs(tp["render"].numpy() - np.asarray(jp["render"])).max() \
        < 1e-2 * gap
