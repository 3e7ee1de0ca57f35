"""Port parity, the trainer: the camera picks and the overflow margins
against the JAX trainer's; and `Trainer.train` against the JAX trainer on
one written dataset: 12 iterations without densification, a run through
one densify epoch, and the fine stage's rollback.

The JAX side runs its Pallas rasterizer in interpret mode and its SSIM
blur as a float32 product (`f32_blur`). The two trainers start from one
state (the JAX trainer's, carried across by `convert.py`: the packages
seed their decoders differently). Tolerances: the loss
history rtol 1e-4 and the final tables within 2e-4 x each one's max
where Adam's first moment is not near zero (`_assert_tables_close`); a
densify epoch, entered from the JAX trainer's state (so that a threshold
flipped by float order cannot fork the runs), exactly."""
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horizongs_tpu.native
import horizongs_tpu_torch.native
import horizongs_tpu.train.trainer as jtrainer_mod
from horizongs_tpu.config import make_model_params as j_model_params
from horizongs_tpu.config import make_optim as j_make_optim
from horizongs_tpu.config import make_pipeline as j_make_pipeline
from horizongs_tpu.data.scene import Scene as JScene
from horizongs_tpu.data.synthetic import (
    write_synthetic_blender_dataset as j_write_synthetic)
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu_torch.config import (
    make_model_params,
    make_optim,
    make_pipeline,
)
from horizongs_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.train import trainer as ttrainer_mod
from horizongs_tpu_torch.train.trainer import Trainer
from test_torch_losses import f32_blur  # noqa: F401  (fixture)
from test_torch_train import _j_groups, _leaves, _np

torch.set_num_threads(1)

W = H = 48
SCENE = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
             voxel_size=0.3, fork=2, aerial_levels=2, street_levels=4,
             standard_dist=8.0, render_mode="RGB+ED")


@pytest.fixture(autouse=True)
def pil_only(monkeypatch):
    """Both packages' loaders through PIL (`test_torch_data.py`)."""
    monkeypatch.setattr(horizongs_tpu.native, "available", lambda: False)
    monkeypatch.setattr(horizongs_tpu_torch.native, "available",
                        lambda: False)


# --- camera picks and overflow margins ---------------------------------------

def _bare(cls, pp, n_aerial=8, n_street=4, seed=3):
    """A trainer of `cls` with only what the picks and margins read."""
    cams = ([SimpleNamespace(uid=i, image_type="aerial")
             for i in range(n_aerial)]
            + [SimpleNamespace(uid=100 + i, image_type="street")
               for i in range(n_street)])
    t = object.__new__(cls)
    t.pp = pp
    t.scene = SimpleNamespace(get_train_cameras=lambda: list(cams))
    t.rng = __import__("random").Random(seed)
    t.np_rng = np.random.default_rng(seed)
    t._cap_margin = defaultdict(lambda: 1.15)
    t._band_margin = defaultdict(lambda: 1.25)
    t._margin_capped = set()
    t._steps = {}
    t.band_cap = None
    t.log = lambda *a, **k: None
    t.records = {"overflows": []}
    return t


@pytest.mark.parametrize("balance", [True, False],
                         ids=["aerial_street_2_1", "all"])
def test_camera_picks_match_jax(balance):
    kw = dict(camera_balance=balance, camera_proportion="2-1")
    t = _bare(Trainer, make_pipeline(**kw))
    j = _bare(jtrainer_mod.Trainer, j_make_pipeline(**kw))
    st, sj = defaultdict(list), defaultdict(list)
    got = [t._pick_camera(st).uid for _ in range(200)]
    want = [j._pick_camera(sj).uid for _ in range(200)]
    assert got == want
    assert len(set(got)) == 12


def test_overflow_margins_match_jax():
    t = _bare(Trainer, make_pipeline())
    j = _bare(jtrainer_mod.Trainer, j_make_pipeline())
    res = (48, 48)
    got, want = [], []
    for i in range(10):
        t._steps[(48, 48, 4096, None, True)] = "step"
        j._steps[(48, 48, 4096, None, True)] = "step"
        got.append((t._handle_overflow(res, 100, i), t._cap_margin[res],
                    bool(t._steps)))
        want.append((j._handle_overflow(res, 100, 0, i), j._cap_margin[res],
                     bool(j._steps)))
    assert got == want
    assert Trainer.MARGIN_CEIL == jtrainer_mod.Trainer.MARGIN_CEIL
    assert got[-1][1] <= Trainer.MARGIN_CEIL
    assert [r["widened"] for r in t.records["overflows"]].count(True) == 5


# --- Trainer.train against the JAX trainer ----------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trainer_data"))
    j_write_synthetic(path, n_train=6, n_test=2, width=W, height=H)
    return path


def _trainers(dataset, tmp_path, okw, **lp_kw):
    """A JAX trainer and a port trainer on one dataset, the port's state
    the JAX trainer's."""
    lp_kw = dict(data_format="blender", source_path=dataset, resolution=1,
                 **lp_kw)
    pkw = dict(add_prefilter=True, vis_step=0)
    okw = dict(dict(feature_lr=0.03, mlp_color_lr_init=0.02,
                    lambda_dreg=0.0, lambda_sky_opa=0.0,
                    lambda_opacity_entropy=0.0), **okw)
    js = JScene(j_model_params(model_path=str(tmp_path / "j"), **lp_kw),
                JConfig(**SCENE))
    jt = jtrainer_mod.Trainer(js.cfg, j_make_optim(**okw),
                              j_make_pipeline(**pkw), js,
                              rasterizer="pallas_interpret")
    ts = Scene(make_model_params(model_path=str(tmp_path / "t"), **lp_kw),
               ModelConfig(**SCENE), device="cpu")
    tt = Trainer(ts.cfg, make_optim(**okw), make_pipeline(**pkw), ts)
    tt.state = train_state_from_numpy(_np(jt.state), device="cpu")
    return jt, tt


def _assert_tables_close(t_state, j_state):
    """Every table within 2e-4 x its max, where Adam's first moment is at
    least 1% of the table's largest: Adam normalises a near-zero gradient
    to a full +-lr step, so such an entry follows the sign that float
    order gives its gradient (as the one-step test holds parameters only
    where the gradient is large)."""
    got = _leaves(train_state_to_numpy(t_state)["params"])
    want = _leaves(_np(_j_groups(j_state.params)))
    mu = _leaves(_np(_j_groups(j_state.opt.mu)))
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        held = np.abs(mu[k]) >= 1e-2 * np.abs(mu[k]).max()
        assert held.any(), k
        assert np.abs(got[k] - want[k])[held].max() <= 2e-4 * scale, k


def test_trainer_matches_jax(dataset, tmp_path, f32_blur):
    """12 iterations, statistics on, no densify epoch."""
    okw = dict(iterations=12, start_stat=2, update_from=1000,
               update_interval=4, update_until=1000)
    jt, tt = _trainers(dataset, tmp_path, okw)
    hist_j = jt.train()
    hist_t = tt.train()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    _assert_tables_close(tt.state, jt.state)
    np.testing.assert_allclose(tt.state.stats.anchor_demon.numpy(),
                               np.asarray(jt.state.stats.anchor_demon))
    assert len(tt.records["step_ms"]) == 12
    assert not tt.records["densify"] and not tt.records["overflows"]


def _capture(monkeypatch, module, name, sink):
    """Wrap `module.name` to append its numpy input state and output."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        i = 2 if name == "run_densify" else 0
        out = orig(*args, **kw)
        sink.append((args[3] if name == "run_densify" else None,
                     _np(args[i]), _np(out)))
        return out
    monkeypatch.setattr(module, name, wrapped)


def _substitute(monkeypatch, name, captured, checked):
    """Wrap the port trainer's `name` to enter it from the JAX trainer's
    input state and hold its output to the JAX trainer's, exactly."""
    orig = getattr(ttrainer_mod, name)
    i = 2 if name == "run_densify" else 0

    def wrapped(*args, **kw):
        it, j_in, j_out = captured[len(checked)]
        args = list(args)
        args[i] = train_state_from_numpy(j_in, device="cpu")
        out = orig(*args, **kw)
        assert out.n == int(j_out.n)
        got = train_state_to_numpy(out)
        for f in ("level", "extra_level", "rotation"):
            np.testing.assert_array_equal(got[f], getattr(j_out, f),
                                          err_msg=f)
        for k, v in _leaves(_j_groups(j_out.params)).items():
            np.testing.assert_array_equal(_leaves(got["params"])[k], v,
                                          err_msg=k)
        checked.append(it)
        return out
    monkeypatch.setattr(ttrainer_mod, name, wrapped)


def test_trainer_densify_epoch_matches_jax(dataset, tmp_path, f32_blur,
                                           monkeypatch):
    """Through one densify epoch: the epoch equal, then the next three
    losses."""
    okw = dict(iterations=12, start_stat=1, update_from=4,
               update_interval=4, update_until=1000,
               densify_grad_threshold=1e-6, success_threshold=0.5)
    jt, tt = _trainers(dataset, tmp_path, okw)
    captured, checked = [], []
    _capture(monkeypatch, jtrainer_mod, "run_densify", captured)
    hist_j = jt.train()
    assert len(captured) >= 1
    e = captured[0][0]
    assert e <= 9
    _substitute(monkeypatch, "run_densify", captured, checked)
    hist_t = tt.train(iterations=e + 3)
    assert checked == [e]
    rep = tt.records["densify"][0]
    assert rep["added"] > 0 and rep["anchors_after"] == int(
        captured[0][2].n)
    np.testing.assert_allclose(hist_t[:e - 1], hist_j[:e - 1], rtol=1e-4)
    np.testing.assert_allclose(hist_t[e:e + 3], hist_j[e:e + 3], rtol=1e-4)


def test_trainer_fine_stage_rollback_matches_jax(dataset, tmp_path,
                                                 f32_blur, monkeypatch):
    """The fine stage from a coarse iteration: the rollback before its
    densify epoch restores the same rows as the JAX trainer's."""
    okw = dict(iterations=12, start_stat=1, update_from=4,
               update_interval=4, update_until=1000,
               densify_grad_threshold=1e-6, success_threshold=0.5)
    jt, _ = _trainers(dataset, tmp_path / "coarse", dict(okw, iterations=4))
    jt.train()
    jt.scene.save(4, jt.state)
    ckpt = str(tmp_path / "coarse" / "j" / "point_cloud" / "iteration_4")
    jt, tt = _trainers(dataset, tmp_path / "fine", okw,
                       pretrained_checkpoint=ckpt)
    assert tt.scene.stage == "fine" and tt.scene.frozen_mlps
    for k in jt.scene.base:
        np.testing.assert_array_equal(tt.scene.base[k], jt.scene.base[k])
    mlp0 = _leaves(_np(_j_groups(jt.state.params)))   # train() donates
    captured, checked = [], []
    _capture(monkeypatch, jtrainer_mod, "roll_back", captured)
    jt.train()
    assert captured
    _substitute(monkeypatch, "roll_back", captured, checked)
    tt.train()
    assert len(checked) == len(captured)
    got = _leaves(train_state_to_numpy(tt.state)["params"])
    for k in mlp0:
        if k.startswith("mlp_"):     # frozen: bit for bit the coarse ones
            np.testing.assert_array_equal(got[k], mlp0[k], err_msg=k)
