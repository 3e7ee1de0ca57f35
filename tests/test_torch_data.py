"""Port parity, data: each dataset reader on a written dataset (Blender,
COLMAP, MatrixCity-style city, UCGS) against the JAX package's reader;
`load_camera` at resolution 1 and 2, both packages through PIL and, where
the native loader builds, both through it (`tests/test_torch_native.py`
holds the loaders themselves); the synthetic dataset writer; `Scene`
coarse, fine and loaded from a saved iteration; and the evaluation
(`render_set`, `evaluate_sets`) on the same state and cameras.

Tolerances: reader outputs atol 1e-6 (they are the same numpy code);
images and masks exactly; the writer's 8-bit frames within one level on
at most 0.1% of the bytes (the two dense renders differ in the last
place); renders atol 1e-4 (`ROADMAP.md`, "Tolerances"), per-view PSNR and
SSIM atol 1e-4 with the JAX SSIM blur as a float32 product (`f32_blur`).
"""
import dataclasses
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import horizongs_tpu.native
import horizongs_tpu_torch.native
from horizongs_tpu.config import make_model_params as j_model_params
from horizongs_tpu.data import camera_build as jcb
from horizongs_tpu.data import colmap as jcol
from horizongs_tpu.data import readers as jrd
from horizongs_tpu.data.scene import Scene as JScene
from horizongs_tpu.data.synthetic import (
    write_synthetic_blender_dataset as j_write_synthetic)
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.train import evaluate as jev
from horizongs_tpu_torch.config import make_model_params
from horizongs_tpu_torch.convert import train_state_from_numpy
from horizongs_tpu_torch.data import camera_build as tcb
from horizongs_tpu_torch.data import readers as trd
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.data.synthetic import write_synthetic_blender_dataset
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.train import evaluate as tev
from test_torch_losses import f32_blur  # noqa: F401  (fixture)

torch.set_num_threads(1)

W = H = 48
LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           voxel_size=0.3, fork=2, aerial_levels=2, street_levels=4,
           standard_dist=8.0, render_mode="RGB+ED")


_NATIVE_AVAILABLE = horizongs_tpu.native.available
_T_NATIVE_AVAILABLE = horizongs_tpu_torch.native.available


@pytest.fixture(autouse=True)
def pil_only(monkeypatch):
    """Both packages' loaders through PIL (see the module doc)."""
    monkeypatch.setattr(horizongs_tpu.native, "available", lambda: False)
    monkeypatch.setattr(horizongs_tpu_torch.native, "available",
                        lambda: False)


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("blender"))
    j_write_synthetic(path, n_train=6, n_test=2, width=W, height=H)
    return path


def _assert_cam_infos_equal(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        da, db = dataclasses.asdict(ca), dataclasses.asdict(cb)
        assert da.keys() == db.keys()
        for k in da:
            if isinstance(da[k], np.ndarray):
                np.testing.assert_allclose(da[k], db[k], rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert da[k] == db[k], k


def _assert_scene_infos_equal(a, b):
    _assert_cam_infos_equal(a.train_cameras, b.train_cameras)
    _assert_cam_infos_equal(a.test_cameras, b.test_cameras)
    np.testing.assert_allclose(a.nerf_normalization["translate"],
                               b.nerf_normalization["translate"], atol=1e-6)
    assert abs(a.nerf_normalization["radius"]
               - b.nerf_normalization["radius"]) <= 1e-6
    for f in ("points", "colors", "normals"):
        np.testing.assert_allclose(getattr(a.point_cloud, f),
                                   getattr(b.point_cloud, f), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert a.ply_path == b.ply_path


def _colmap_scene(root, names, seed, width=40, height=30):
    """A COLMAP scene: sparse/0 binary model + PNG images."""
    rng = np.random.default_rng(seed)
    cams = {1: jcol.ColmapCamera(1, "PINHOLE", width, height,
                                 np.array([38.0, 36.0, 20.0, 15.0]))}
    images = {}
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, name in enumerate(names, start=1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = jcol.ColmapImage(i, q, rng.normal(size=3), 1, name,
                                     np.zeros((0, 2)),
                                     np.zeros((0,), np.int64))
        Image.fromarray(rng.integers(0, 256, (height, width, 3),
                                     dtype=np.uint8)).save(
            os.path.join(root, "images", name))
    xyz = rng.normal(size=(80, 3))
    rgb = rng.integers(0, 256, (80, 3)).astype(np.float64)
    jcol.write_model(cams, images, xyz, rgb, rng.uniform(size=80),
                     os.path.join(root, "sparse", "0"))


def test_blender_reader_matches(blender):
    kw = dict(eval=True, add_mask=False, add_depth=False)
    _assert_scene_infos_equal(trd.read_blender_scene(blender, **kw),
                              jrd.read_blender_scene(blender, **kw))
    # eval off: the test views join the training set
    _assert_scene_infos_equal(trd.read_blender_scene(blender, eval=False),
                              jrd.read_blender_scene(blender, eval=False))


def test_blender_reader_random_cloud_matches(blender, tmp_path):
    """Without a PLY both readers draw the same cloud from the global
    numpy RNG (and write it)."""
    path = str(tmp_path / "noply")
    shutil.copytree(blender, path)
    os.remove(os.path.join(path, "points3d.ply"))
    np.random.seed(11)
    j = jrd.read_blender_scene(path)
    with open(j.ply_path, "rb") as f:
        j_bytes = f.read()
    os.remove(j.ply_path)
    np.random.seed(11)
    t = trd.read_blender_scene(path)
    _assert_scene_infos_equal(t, j)
    with open(t.ply_path, "rb") as f:
        assert f.read() == j_bytes


def test_colmap_reader_matches(tmp_path):
    root = str(tmp_path / "colmap")
    _colmap_scene(root, [f"aerial_{i:02d}.png" for i in range(5)]
                  + [f"street_{i:02d}.png" for i in range(3)], seed=1)
    for kw in (dict(llffhold=3), dict(llffhold=3, add_street=False),
               dict(eval=False)):
        _assert_scene_infos_equal(trd.read_colmap_scene(root, **kw),
                                  jrd.read_colmap_scene(root, **kw))


def test_city_reader_matches(blender, tmp_path):
    path = str(tmp_path / "city")
    shutil.copytree(blender, path)
    shutil.copy(os.path.join(path, "transforms_train.json"),
                os.path.join(path, "transforms.json"))
    for kw in (dict(llffhold=4), dict(llffhold=4, center=(0.1, 0, -0.2),
                                      scale=2.0)):
        _assert_scene_infos_equal(trd.read_city_scene(path, **kw),
                                  jrd.read_city_scene(path, **kw))


def test_ucgs_reader_matches(tmp_path):
    root = str(tmp_path / "ucgs_NYC")
    for j, sub in enumerate(jrd.UCGS_SUBDIRS["NYC"]):
        _colmap_scene(os.path.join(root, sub),
                      ["train_0003.png", "train_0400.png", "eval_0010.png",
                       "train_0360.png", "eval_0500.png"], seed=5 + j)
    for kw in (dict(), dict(add_street=False), dict(aerial_min_index=1)):
        _assert_scene_infos_equal(trd.read_ucgs_scene(root, **kw),
                                  jrd.read_ucgs_scene(root, **kw))


def _with_depth(blender, tmp_path):
    """The Blender dataset with a metric depth map (.npy) per frame."""
    path = str(tmp_path / "depth")
    shutil.copytree(blender, path)
    rng = np.random.default_rng(4)
    os.makedirs(os.path.join(path, "depth"))
    for name in ("transforms_train.json", "transforms_test.json"):
        with open(os.path.join(path, name)) as f:
            d = json.load(f)
        for fr in d["frames"]:
            rel = "depth/" + os.path.basename(fr["file_path"]) + ".npy"
            # a sky: far pixels past a 100x range are masked out
            depth = rng.uniform(2e4, 6e4, (H, W)).astype(np.float32)
            depth[: H // 4] = 1e7
            np.save(os.path.join(path, rel), depth)
            fr["depth_path"] = rel
        with open(os.path.join(path, name), "w") as f:
            json.dump(d, f)
    return path


def _assert_cameras_equal(a, b):
    assert (a.width, a.height, a.uid, a.image_type, a.subset,
            a.resolution_scale) == (b.width, b.height, b.uid, b.image_type,
                                    b.subset, b.resolution_scale)
    for f in ("viewmat", "K", "cam_center", "image", "alpha_mask",
              "invdepth", "depth_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f)


@pytest.mark.parametrize("resolution", [1, 2])
@pytest.mark.parametrize("depth", [False, True], ids=["rgba", "depth"])
def test_load_camera_matches(resolution, depth, blender, tmp_path,
                             monkeypatch):
    path = _with_depth(blender, tmp_path) if depth else blender
    infos = jrd.read_blender_scene(path, add_depth=depth).train_cameras
    args_j = j_model_params(resolution=resolution, data_format="blender")
    args_t = make_model_params(resolution=resolution, data_format="blender")
    got = tcb.camera_list(infos, args_t, 1.0, device="cpu")
    if _NATIVE_AVAILABLE() and _T_NATIVE_AVAILABLE():
        # both loaders' native decoders: bit for bit, resized or not (the
        # native resize is not PIL's)
        with monkeypatch.context() as m:
            m.setattr(horizongs_tpu.native, "available", _NATIVE_AVAILABLE)
            m.setattr(horizongs_tpu_torch.native, "available",
                      _T_NATIVE_AVAILABLE)
            native = jcb.camera_list(infos, args_j, 1.0)
            native_t = tcb.camera_list(infos, args_t, 1.0, device="cpu")
        for g, w in zip(native_t, native):
            _assert_cameras_equal(g, w)
    want = jcb.camera_list(infos, args_j, 1.0)
    assert {c.image_type for c in got} == {"aerial", "street"}
    for g, w in zip(got, want):
        assert g.width == W // resolution
        if depth:
            assert g.invdepth is not None
            assert 0 < float(g.alpha_mask.mean()) < 1
        _assert_cameras_equal(g, w)
    for i, info in enumerate(infos[:2]):
        assert tcb.camera_to_json(i, info) == jcb.camera_to_json(i, info)


def test_synthetic_writer_matches(tmp_path):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    gj = j_write_synthetic(pj, n_train=6, n_test=2, width=W, height=H)
    gt = write_synthetic_blender_dataset(pt, n_train=6, n_test=2, width=W,
                                         height=H, device="cpu")
    for k in gt:
        np.testing.assert_array_equal(gt[k], np.asarray(gj[k]), err_msg=k)
    for name in ("transforms_train.json", "transforms_test.json",
                 "points3d.ply"):
        with open(os.path.join(pj, name), "rb") as a, \
                open(os.path.join(pt, name), "rb") as b:
            assert a.read() == b.read(), name
    pngs = sorted(os.path.relpath(p, pj)
                  for p in glob.glob(os.path.join(pj, "*", "*.png")))
    assert len(pngs) == 8
    n_diff = n_all = 0
    for rel in pngs:
        a = np.asarray(Image.open(os.path.join(pj, rel))).astype(np.int16)
        b = np.asarray(Image.open(os.path.join(pt, rel))).astype(np.int16)
        assert a.shape == b.shape == (H, W, 4)
        assert np.abs(a - b).max() <= 1, rel
        n_diff += int((a != b).sum())
        n_all += a.size
    assert n_diff <= 1e-3 * n_all


def _scenes(blender, tmp_path, **lp_kw):
    lp_kw = dict(data_format="blender", source_path=blender, resolution=1,
                 **lp_kw)
    lpj = j_model_params(model_path=str(tmp_path / "j"), **lp_kw)
    lpt = make_model_params(model_path=str(tmp_path / "t"), **lp_kw)
    return (Scene(lpt, ModelConfig(**LOD), device="cpu", logger=None),
            JScene(lpj, JConfig(**LOD)))


def _assert_states_equal(t_state, j_state):
    a, b = t_state.anchor_state(), j_state.anchor_state()
    assert a.n == int(b.n)
    for f in ("anchor", "offset", "feat", "scaling_log", "rotation",
              "level", "extra_level"):
        np.testing.assert_array_equal(getattr(a, f).detach().numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_scene_coarse_matches(blender, tmp_path):
    t, j = _scenes(blender, tmp_path, white_background=True)
    _assert_states_equal(t.train_state, j.train_state)
    assert t.cameras_extent == j.cameras_extent
    np.testing.assert_array_equal(t.cam_infos, j.cam_infos)
    np.testing.assert_array_equal(t.background.numpy(),
                                  np.asarray(j.background))
    assert (t.stage, t.frozen_mlps, t.base) == ("coarse", False, None)
    for name in ("input.ply", "cameras.json"):
        with open(tmp_path / "t" / name, "rb") as a, \
                open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name
    for a, b in zip(t.get_train_cameras() + t.get_test_cameras(),
                    j.get_train_cameras() + j.get_test_cameras()):
        _assert_cameras_equal(a, b)
    assert t.camera_bytes() == 8 * H * W * 4 * 4
    # `explicit` selects the baked model of a loaded iteration only; with
    # none to load, the scene initialises its training state as the JAX
    # package's does (`test_torch_explicit.py` loads a bake)
    e = Scene(t.lp, ModelConfig(**LOD), explicit=True, device="cpu")
    assert e.explicit_state is None
    _assert_states_equal(e.train_state, j.train_state)


def test_scene_fine_and_loaded_match(blender, tmp_path):
    """Fine stage from a coarse iteration the JAX package saved (frozen
    MLPs, base copies), and a load of that saved iteration."""
    _, j = _scenes(blender, tmp_path / "coarse")
    rng = np.random.default_rng(2)
    st = j.train_state
    live = (np.arange(st.params.feat.shape[0]) < int(st.n))[:, None]
    feat = rng.normal(size=st.params.feat.shape).astype(np.float32) * live
    st = st._replace(params=st.params._replace(feat=jnp.asarray(feat)))
    j.save(30, st)
    ckpt = str(tmp_path / "coarse" / "j" / "point_cloud" / "iteration_30")
    t, j = _scenes(blender, tmp_path / "fine", pretrained_checkpoint=ckpt)
    assert (t.stage, t.frozen_mlps) == (j.stage, j.frozen_mlps) == (
        "fine", True)
    _assert_states_equal(t.train_state, j.train_state)
    assert t.base.keys() == j.base.keys()
    for k in j.base:
        np.testing.assert_array_equal(t.base[k], j.base[k], err_msg=k)
    lp = make_model_params(model_path=str(tmp_path / "coarse" / "j"),
                           data_format="blender", source_path=blender,
                           resolution=1)
    loaded = Scene(lp, ModelConfig(**LOD), load_iteration=-1, device="cpu")
    assert loaded.loaded_iter == 30
    _assert_states_equal(loaded.train_state, st)


def test_evaluation_matches(blender, tmp_path, f32_blur):
    """`render_set` + `evaluate_sets` on one state and the test cameras:
    the same renders, counts, PSNR and SSIM."""
    t, j = _scenes(blender, tmp_path)
    rng = np.random.default_rng(7)
    st = j.train_state
    live = (np.arange(st.params.feat.shape[0]) < int(st.n))[:, None]
    st = st._replace(params=st.params._replace(
        feat=jnp.asarray(rng.normal(size=st.params.feat.shape)
                         .astype(np.float32) * live),
        offset=jnp.asarray(0.3 * rng.normal(size=st.params.offset.shape)
                           .astype(np.float32) * live[:, :, None])))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    out_t, out_j = str(tmp_path / "eval_t"), str(tmp_path / "eval_j")
    rt = tev.render_set(out_t, "test", 5, t.get_test_cameras(), t.cfg, t,
                        ts)
    rj = jev.render_set(out_j, "test", 5, j.get_test_cameras(), j.cfg, j,
                        st, rasterizer="pallas_interpret")
    for a, b in zip(rt[0], rj[0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(rt[1], rj[1]):
        np.testing.assert_array_equal(a, b)
    assert rt[2] == rj[2] and rt[4] == rj[4] and rt[5] == rj[5]
    assert min(rt[2]) > 0
    assert sorted(os.listdir(os.path.join(out_t, "test", "ours_5"))) == \
        sorted(os.listdir(os.path.join(out_j, "test", "ours_5")))
    res_t = tev.evaluate_sets(out_t, 5, rt[0], rt[1], rt[4], device="cpu")
    res_j = jev.evaluate_sets(out_j, 5, rj[0], rj[1], rj[4])
    assert res_t.keys() == res_j.keys()
    with open(os.path.join(out_t, "per_view_test.json")) as f:
        pv_t = json.load(f)["ours_5"]
    with open(os.path.join(out_j, "per_view_test.json")) as f:
        pv_j = json.load(f)["ours_5"]
    for m in ("PSNR", "SSIM"):
        for k in pv_j[m]:
            assert abs(pv_t[m][k] - pv_j[m][k]) <= 1e-4, (m, k)
    assert res_t["all"]["LPIPS"] is None
    assert tev.lpips_fn_or_none() is None
