"""Port parity, the slice: `render()` of the flagship LOD model against
the JAX package's Pallas path (interpret mode), with the JAX weights
carried across by `convert.py`, seeded feat noise with and without offset
noise (zero offsets put the ten children of an anchor at one mean and
depth), prefilter on and off. Tolerances as `tests/test_raster_pallas.py`:
images atol 1e-4 (rtol 2e-4 on ED depth), alphas atol 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from horizongs_tpu.render import count_render_instances as j_count
from horizongs_tpu.render import render as j_render
from horizongs_tpu.train.optim import mlps_from_params
from horizongs_tpu_torch.convert import anchor_state_from_numpy, mlps_from_numpy
from horizongs_tpu_torch.data.synthetic import lookat_camera, orbit_cameras
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.render import count_render_instances as t_count
from horizongs_tpu_torch.render import render as t_render


@pytest.fixture(scope="module")
def flagship():
    cfg, ts, cams = _flagship()
    return cfg, ts, cams[0]


def _models(flagship, offset_noise: bool):
    cfg, ts, jcam = flagship
    js = ts.anchor_state()
    rng = np.random.default_rng(11)
    live = (np.arange(js.capacity) < int(js.n))[:, None]
    feat = rng.normal(size=js.feat.shape).astype(np.float32) * live
    offset = np.zeros(js.offset.shape, np.float32)
    if offset_noise:
        offset = (rng.normal(size=js.offset.shape).astype(np.float32)
                  * live[:, :, None])
    js = js._replace(feat=jnp.asarray(feat), offset=jnp.asarray(offset))
    jm = mlps_from_params(ts.params)
    ts_ = anchor_state_from_numpy(jax.tree.map(np.asarray, js._asdict()),
                                  device="cpu")
    tm = mlps_from_numpy(**jax.tree.map(np.asarray, jm._asdict()),
                         device="cpu")
    tcfg = ModelConfig(**{f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__})
    tcam = orbit_cameras(1, radius=3.5, height_z=-1.0, width=jcam.width,
                         height=jcam.height, device="cpu")[0]
    return (cfg, jm, js, jcam), (tcfg, tm, ts_, tcam)


@pytest.mark.parametrize("offset_noise", [True, False],
                         ids=["offset_noise", "zero_offsets"])
@pytest.mark.parametrize("prefilter", [True, False],
                         ids=["prefilter", "no_prefilter"])
def test_render_matches_pallas(flagship, offset_noise, prefilter):
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _models(flagship,
                                                        offset_noise)
    n_j = int(j_count(jcam, cfg, jm, js, add_prefilter=prefilter))
    n_t = t_count(tcam, tcfg, tm, ts, add_prefilter=prefilter)
    assert n_t == n_j > 0
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jp = j_render(jcam, cfg, jm, js, jnp.asarray(bg),
                  add_prefilter=prefilter, rasterizer="pallas_interpret")
    with torch.no_grad():
        tp = t_render(tcam, tcfg, tm, ts, torch.from_numpy(bg),
                      add_prefilter=prefilter, rasterizer="cuda")
    assert int(tp["n_dropped"]) == int(jp["n_dropped"]) == 0
    assert int(tp["n_instances"]) == int(jp["n_instances"]) == n_j
    np.testing.assert_array_equal(tp["visible_mask"].numpy(),
                                  np.asarray(jp["visible_mask"]))
    np.testing.assert_array_equal(tp["radii"].numpy(), np.asarray(jp["radii"]))
    np.testing.assert_allclose(tp["render"].numpy(), np.asarray(jp["render"]),
                               atol=1e-4)
    np.testing.assert_allclose(tp["render_alphas"].numpy(),
                               np.asarray(jp["render_alphas"]), atol=2e-5)
    np.testing.assert_allclose(tp["render_depth"].numpy(),
                               np.asarray(jp["render_depth"]), atol=1e-4,
                               rtol=2e-4)
    assert float(jp["render_alphas"].max()) > 0.5   # the model is visible


def test_dense_rasterizer_matches_cuda_path(flagship):
    _, (tcfg, tm, ts, tcam) = _models(flagship, offset_noise=True)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        c = t_render(tcam, tcfg, tm, ts, bg, rasterizer="cuda")
        d = t_render(tcam, tcfg, tm, ts, bg, rasterizer="dense")
    for key in ("render", "render_alphas"):
        torch.testing.assert_close(c[key], d[key], atol=1e-4, rtol=0)
    torch.testing.assert_close(c["render_depth"], d["render_depth"],
                               atol=1e-4, rtol=2e-4)


def test_2dgs_and_default_device_refused(flagship):
    _, (tcfg, tm, ts, tcam) = _models(flagship, offset_noise=False)
    cfg2d = ModelConfig(**{**tcfg.__dict__, "gs_attr": "2D"})
    with pytest.raises(NotImplementedError, match="2DGS"):
        t_render(tcam, cfg2d, tm, ts, torch.zeros(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lookat_camera(width=32, height=32)
