"""Port parity, models: anchor init, LOD masks and the neural decode, with
the JAX package's weights carried across by `convert.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.models import anchors as janc
from horizongs_tpu.models.config import ModelConfig as JConfig
from horizongs_tpu.models.mlp import init_mlps as j_init_mlps
from horizongs_tpu_torch.convert import anchor_state_from_numpy, mlps_from_numpy
from horizongs_tpu_torch.models import anchors as tanc
from horizongs_tpu_torch.models.config import ModelConfig as TConfig

CFG = dict(name="GaussianLoDModel", feat_dim=16, n_offsets=5, view_dim=3,
           voxel_size=0.1, fork=2, aerial_levels=3, street_levels=4,
           standard_dist=3.0)


def _points(n=400, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def _pair(**overrides):
    kw = dict(CFG, **overrides)
    return JConfig(**kw), TConfig(**kw)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy_state(jcfg, seed=1, capacity=None):
    """JAX anchor state with seeded feat / offset / extra_level noise, and
    the same state in the port."""
    js = janc.init_anchor_state_from_points(jcfg, _points(), capacity=capacity)
    rng = np.random.default_rng(seed)
    live = (np.arange(js.capacity) < int(js.n))[:, None]
    js = js._replace(
        feat=jnp.asarray(rng.normal(size=js.feat.shape).astype(np.float32) * live),
        offset=jnp.asarray(rng.normal(size=js.offset.shape).astype(np.float32)
                           * live[:, :, None]),
        extra_level=jnp.asarray(
            rng.uniform(-0.5, 0.5, js.capacity).astype(np.float32)))
    return js, anchor_state_from_numpy(_to_numpy(js._asdict()), device="cpu")


def test_octree_sample_identical():
    jcfg, tcfg = _pair()
    pj, lj = janc.octree_sample(_points(), jcfg)
    pt, lt = tanc.octree_sample(_points(), tcfg)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("name", ["GaussianLoDModel", "GaussianModel"])
def test_init_anchor_state_identical(name):
    jcfg, tcfg = _pair(name=name)
    js = janc.init_anchor_state_from_points(jcfg, _points())
    ts = tanc.init_anchor_state_from_points(tcfg, _points(), device="cpu")
    assert ts.n == int(js.n) and ts.capacity == js.capacity
    for field in ("anchor", "offset", "feat", "scaling_log", "rotation",
                  "level", "extra_level"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), field)


@pytest.mark.parametrize("rule", ["floor", "round", "ceil", "progressive"])
def test_anchor_lod_mask_matches(rule):
    jcfg, tcfg = _pair(dist2level=rule)
    js, ts = _noisy_state(jcfg)
    center = np.array([0.3, -1.5, -2.0], np.float32)
    jm, jsm = janc.anchor_lod_mask(jcfg, js, jnp.asarray(center), 1.3)
    tm, tsm = tanc.anchor_lod_mask(tcfg, ts, torch.from_numpy(center), 1.3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tsm.numpy(), np.asarray(jsm), atol=1e-6)
    assert 0 < int(jm.sum()) < int(js.n)   # the rule really cuts


@pytest.mark.parametrize("overrides", [
    {},
    {"appearance_dim": 4},
    {"color_attr": "SH3"},
    {"dist2level": "progressive"},
], ids=["flagship", "appearance", "sh3", "progressive"])
def test_decode_matches(overrides):
    jcfg, tcfg = _pair(**overrides)
    js, ts = _noisy_state(jcfg)
    jm = j_init_mlps(jax.random.PRNGKey(3), jcfg.feat_dim, jcfg.view_dim,
                     jcfg.appearance_dim, jcfg.n_offsets, jcfg.color_dim,
                     num_cameras=3)
    tm = mlps_from_numpy(**_to_numpy(jm._asdict()), device="cpu")
    center = np.array([0.5, -2.0, -1.0], np.float32)
    jmask, jsmooth = janc.anchor_lod_mask(jcfg, js, jnp.asarray(center))
    jd = janc.decode_neural_gaussians(jcfg, jm, js, jnp.asarray(center),
                                      jmask, jsmooth,
                                      appearance_id=jnp.asarray(2))
    tmask, tsmooth = tanc.anchor_lod_mask(tcfg, ts, torch.from_numpy(center))
    with torch.no_grad():
        td = tanc.decode_neural_gaussians(tcfg, tm, ts,
                                          torch.from_numpy(center), tmask,
                                          tsmooth, appearance_id=2)
    for field in ("means", "quats", "scales", "opacities", "colors"):
        np.testing.assert_allclose(getattr(td, field).numpy(),
                                   np.asarray(getattr(jd, field)),
                                   atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(td.selection_mask.numpy(),
                                  np.asarray(jd.selection_mask))
    assert int(jd.selection_mask.sum()) > 0


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid here")
    _, tcfg = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        tanc.init_anchor_state_from_points(tcfg, _points())


def test_init_mlps_seeded_bounds():
    from horizongs_tpu_torch.models.mlp import init_mlps
    a = init_mlps(16, 3, 4, 5, 3, num_cameras=2,
                  generator=torch.Generator().manual_seed(5), device="cpu")
    b = init_mlps(16, 3, 4, 5, 3, num_cameras=2,
                  generator=torch.Generator().manual_seed(5), device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    # Kaiming-uniform (a=sqrt(5)) weight and fan-in bias bounds, (in, out)
    assert a.color.w1.shape == (16 + 3 + 4, 16)
    assert a.opacity.w2.shape == (16, 5) and a.cov.w2.shape == (16, 35)
    with torch.no_grad():
        assert float(a.cov.w1.abs().max()) <= np.sqrt(3.0 / 19)
        assert float(a.cov.b1.abs().max()) <= 1 / np.sqrt(19)
        assert float(a.cov.w2.abs().max()) <= np.sqrt(3.0 / 16)
    assert a.appearance.shape == (2, 4)
