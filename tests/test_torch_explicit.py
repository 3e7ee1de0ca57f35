"""The explicit (SH-baked) model of the port (`models/explicit.py`, the
explicit PLY of `io/checkpoints.py`, `Scene(explicit=True)`) against the
JAX package's on the CPU. The JAX test's SH1 model
(`tests/test_pipeline_e2e.py:114-121`) crosses with `convert.py`: the
kept rows agree wherever |neural opacity| > 1e-6 and the baked arrays
within 1e-5; an explicit PLY written by either package reads back in the
other exactly; `render_explicit` through the plain K1 and the dense
oracle against the JAX package's Pallas path in interpret mode (images
atol 1e-4, alphas 2e-5), and within 2e-3 of the neural render (the JAX
test's bar); a Scene saves the bake and loads it back as its explicit
state, which `render_set(explicit=True)` renders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.data.synthetic import random_gaussians
from horizongs_tpu.io import checkpoints as jck
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.models import init_anchor_state_from_points
from horizongs_tpu.models import explicit as jex
from horizongs_tpu.models.factory import new_mlps
from horizongs_tpu.models.mlp import mlp_apply
from horizongs_tpu_torch.cli.common import load_config
from horizongs_tpu_torch.convert import anchor_state_from_numpy, mlps_from_numpy
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.data.synthetic import lookat_camera
from horizongs_tpu_torch.io import checkpoints as tck
from horizongs_tpu_torch.models import explicit as tex
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.render import render as t_render
from horizongs_tpu_torch.train.evaluate import render_set
from test_torch_serve_cli import write_config, write_dataset

torch.set_num_threads(1)

KW = dict(name="GaussianLoDModel", feat_dim=16, n_offsets=4, view_dim=0,
          color_attr="SH1", render_mode="RGB", voxel_size=0.3, fork=2,
          aerial_levels=2, street_levels=4, standard_dist=8.0)
FIELDS = ("xyz", "features", "opacity", "scaling", "rotation", "level",
          "extra_level")


@pytest.fixture(scope="module")
def models():
    cfg = JConfig(**KW)
    g = random_gaussians(40, seed=3, extent=0.7)
    state = init_anchor_state_from_points(cfg, g["means"], capacity=256)
    state = state._replace(feat=0.3 * jax.random.normal(
        jax.random.PRNGKey(0), state.feat.shape))
    mlps = new_mlps(cfg, seed=1)
    tstate = anchor_state_from_numpy(
        jax.tree.map(np.asarray, state._asdict()), device="cpu")
    tmlps = mlps_from_numpy(**jax.tree.map(np.asarray, mlps._asdict()),
                            device="cpu")
    return (cfg, mlps, state), (ModelConfig(**KW), tmlps, tstate)


def test_bake_matches_jax(models):
    (cfg, mlps, state), (tcfg, tmlps, tstate) = models
    want = jex.bake_explicit(cfg, mlps, state)
    got = tex.bake_explicit(tcfg, tmlps, tstate)
    n = int(state.n)
    op_j = np.asarray(jnp.tanh(mlp_apply(mlps.opacity, state.feat[:n])))
    op_j = op_j.reshape(-1)
    op_t = tex.decode_explicit(tcfg, tmlps, tstate)["opacity"].numpy()
    np.testing.assert_allclose(op_t, op_j, atol=1e-6)
    sure = np.abs(op_j) > 1e-6
    np.testing.assert_array_equal((op_t > 0)[sure], (op_j > 0)[sure])
    # the rows both keep, in each bake's order
    rows_j, rows_t = np.flatnonzero(op_j > 0), np.flatnonzero(op_t > 0)
    both = np.intersect1d(rows_j, rows_t)
    assert both.shape[0] > 50 and both.shape[0] >= 0.99 * rows_j.shape[0]
    ij, it = np.searchsorted(rows_j, both), np.searchsorted(rows_t, both)
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k][it], want[k][ij], atol=1e-5,
                                   rtol=0, err_msg=k)


def test_bake_refuses_rgb_and_view_dependent(models):
    _, (tcfg, tmlps, tstate) = models
    for kw in ({"color_attr": "RGB"}, {"view_dim": 3}):
        with pytest.raises(ValueError, match="explicit bake"):
            tex.bake_explicit(ModelConfig(**{**KW, **kw}), tmlps, tstate)


def test_explicit_ply_crosses_packages(models, tmp_path):
    (cfg, mlps, state), (tcfg, tmlps, tstate) = models
    arrays = tex.bake_explicit(tcfg, tmlps, tstate)
    p_t = str(tmp_path / "torch.ply")
    tck.save_explicit_ply(p_t, tcfg, arrays)
    j_arrays, j_info = jck.load_explicit_ply(p_t)
    p_j = str(tmp_path / "jax.ply")
    jck.save_explicit_ply(p_j, cfg, j_arrays)
    t_arrays, t_info = tck.load_explicit_ply(p_j)
    assert j_info == t_info and t_info["aerial_levels"] == 2.0
    with open(p_t, "rb") as a, open(p_j, "rb") as b:
        assert a.read() == b.read()
    for k in FIELDS:
        np.testing.assert_array_equal(j_arrays[k], arrays[k], err_msg=k)
        np.testing.assert_array_equal(t_arrays[k], arrays[k], err_msg=k)
        assert t_arrays[k].dtype == j_arrays[k].dtype, k


def test_render_explicit_matches_jax(models):
    (cfg, mlps, state), (tcfg, tmlps, tstate) = models
    arrays = jex.bake_explicit(cfg, mlps, state)
    jst = jex.explicit_state_from_arrays(arrays)
    tst = tex.explicit_state_from_arrays(arrays, device="cpu")
    jcam = j_lookat(width=48, height=48, eye=(0, 0, -4))
    tcam = lookat_camera(width=48, height=48, eye=(0, 0, -4), device="cpu")
    jp = jex.render_explicit(jcam, cfg, jst, jnp.zeros(3),
                             rasterizer="pallas_interpret")
    np.testing.assert_array_equal(
        tex.explicit_gs_mask(tcfg, tst, tcam.cam_center).numpy(),
        np.asarray(jp["gs_mask"]))
    for rast in ("cuda", "dense"):
        tp = tex.render_explicit(tcam, tcfg, tst, torch.zeros(3),
                                 rasterizer=rast)
        assert int(tp["n_dropped"]) == 0
        np.testing.assert_allclose(tp["render"].numpy(),
                                   np.asarray(jp["render"]), atol=1e-4)
        np.testing.assert_allclose(tp["render_alphas"].numpy(),
                                   np.asarray(jp["render_alphas"]),
                                   atol=2e-5)
    assert float(jp["render_alphas"].max()) > 0.5
    # the baked model renders as the neural one (the JAX test's bar)
    with torch.no_grad():
        neural = t_render(tcam, tcfg, tmlps, tstate, torch.zeros(3),
                          add_prefilter=False)["render"]
    np.testing.assert_allclose(tp["render"].numpy(), neural.numpy(),
                               atol=2e-3)


def test_scene_saves_and_loads_the_bake(tmp_path):
    data = write_dataset(str(tmp_path / "data"))
    out = str(tmp_path / "model")
    kw = {k: v for k, v in KW.items() if k != "name"}
    lp, _, _, cfg = load_config(write_config(tmp_path / "c.yaml", data, **kw),
                                out)
    scene = Scene(lp, cfg, device="cpu")
    ts = scene.train_state
    with torch.no_grad():     # seeded features: the zero init bakes little
        ts.params.feat.copy_(0.3 * torch.randn(
            ts.params.feat.shape, generator=torch.Generator().manual_seed(0)))
    scene.save(7, ts)
    baked = tex.bake_explicit(scene.cfg, ts.params.mlps, ts.anchor_state())
    assert baked["xyz"].shape[0] > 0
    loaded = Scene(lp, cfg, load_iteration=7, explicit=True, device="cpu")
    assert loaded.train_state is None and loaded.loaded_iter == 7
    est = loaded.explicit_state
    assert est.n == baked["xyz"].shape[0]
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(est, k)[:est.n].numpy(),
                                      baked[k], err_msg=k)
    cams = loaded.get_test_cameras()
    renders, _, counts, _, _, _ = render_set(
        out, "test", 7, cams, loaded.cfg, loaded, est, explicit=True,
        save_images=False)
    assert len(renders) == len(cams) == 2 and min(counts) > 0
    assert all(np.isfinite(r).all() for r in renders)
