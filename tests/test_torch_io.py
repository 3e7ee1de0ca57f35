"""Port parity, configuration and files: the config defaults and
`load_config` against the JAX package's on every shipped config; the
anchor PLY, `mlps.npz` and the training checkpoint written by one package
and read by the other, in both directions, compared exactly (and the PLY
byte for byte); COLMAP binary and text models read by both packages."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu import config as jcfg
from horizongs_tpu.cli.common import load_config as j_load_config
from horizongs_tpu.data import colmap as jcol
from horizongs_tpu.io import checkpoints as jck
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.models import init_anchor_state_from_points as j_init_state
from horizongs_tpu.models import init_mlps as j_init_mlps
from horizongs_tpu.train import optim as jopt
from horizongs_tpu.train import step as jstep
from horizongs_tpu_torch import config as tcfg
from horizongs_tpu_torch.cli.common import load_config
from horizongs_tpu_torch.convert import train_state_to_numpy
from horizongs_tpu_torch.data import colmap as tcol
from horizongs_tpu_torch.io import checkpoints as tck
from horizongs_tpu_torch.io.plyio import read_ply
from horizongs_tpu_torch.models.config import ModelConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "configs"))
    for f in fs if f.endswith(".yaml"))

LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           voxel_size=0.2, fork=2, aerial_levels=2, street_levels=4,
           standard_dist=8.0, appearance_dim=4)
FLAT = dict(name="GaussianModel", feat_dim=6, n_offsets=3, view_dim=3,
            voxel_size=0.15)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_config_defaults_match():
    for name in ("DEFAULT_MODEL", "DEFAULT_OPTIM", "DEFAULT_PIPELINE"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("path", CONFIGS)
@pytest.mark.parametrize("override", [None, "outputs/elsewhere"],
                         ids=["default_model_path", "override"])
def test_load_config_matches(path, override):
    got = load_config(os.path.join(ROOT, path), override)
    want = j_load_config(os.path.join(ROOT, path), override)
    for g, w in zip(got[:3], want[:3]):
        assert vars(g) == vars(w)
    assert got[3].__dict__ == want[3].__dict__
    if override is None and not want[0].model_path:
        assert got[0].model_path == os.path.join(
            "outputs", str(want[0].dataset_name), str(want[0].scene_name))


def _j_train_state(cfg_kw, seed=0, capacity=4096):
    """A JAX `TrainState` whose every leaf (moments and statistics too) is
    drawn from `seed`, with an appearance table."""
    cfg = JConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    st = j_init_state(cfg, pts, capacity=capacity)
    mlps = j_init_mlps(jax.random.PRNGKey(seed), cfg.feat_dim, cfg.view_dim,
                       cfg.appearance_dim, cfg.n_offsets, cfg.color_dim,
                       num_cameras=5)
    C, k, n = capacity, cfg.n_offsets, int(st.n)
    live = (np.arange(C) < n)

    def draw(a):
        a = np.asarray(a)
        out = rng.normal(size=a.shape).astype(a.dtype)
        return out * live.reshape((C,) + (1,) * (a.ndim - 1))

    params = jopt.TrainableParams(
        anchor=st.anchor, offset=draw(st.offset), feat=draw(st.feat),
        scaling_log=draw(st.scaling_log), mlp_opacity=mlps.opacity,
        mlp_cov=mlps.cov, mlp_color=mlps.color, appearance=mlps.appearance)
    params = jax.tree.map(jnp.asarray, params)
    opt = jopt.AdamState(
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), params),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(size=a.shape).astype(np.float32)), params),
        t=jnp.asarray(37, jnp.int32))
    stats = jstep.DensifyStats(*(jnp.asarray(
        rng.uniform(size=C * (k if i > 1 else 1)).astype(np.float32))
        for i in range(6)))
    level = np.asarray(st.level).copy()
    if cfg.is_lod:
        level[:n] = rng.integers(0, cfg.street_levels, n)
    extra = draw(st.extra_level)
    return cfg, jstep.TrainState(
        params=params, rotation=jnp.asarray(draw(st.rotation)),
        level=jnp.asarray(level), extra_level=jnp.asarray(extra),
        n=st.n, opt=opt, stats=stats)


@pytest.mark.parametrize("cfg_kw", [LOD, FLAT], ids=["lod", "flat"])
def test_anchor_ply_both_directions(cfg_kw, tmp_path):
    cfg_j, ts = _j_train_state(cfg_kw)
    cfg_t = ModelConfig(**cfg_kw)
    ast_j = ts.anchor_state()
    n = int(ast_j.n)
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jck.save_anchor_ply(pj, cfg_j, ast_j)
    got, info_t = tck.load_anchor_ply(pj, cfg_t, device="cpu")
    back, info_j = jck.load_anchor_ply(pj, cfg_j)
    assert info_t == info_j
    assert got.n == n and got.capacity == int(back.anchor.shape[0])
    for f in ("anchor", "offset", "feat", "scaling_log", "rotation",
              "level", "extra_level"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(back, f)),
                                      err_msg=f)
    # the port writes the same bytes; the JAX package reads them back
    tck.save_anchor_ply(pt, cfg_t, got)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    again, info2 = jck.load_anchor_ply(pt, cfg_j, capacity=got.capacity)
    assert info2 == info_j
    # the flat model's PLY has no level columns: they load as zeros
    for f in ("anchor", "offset", "feat", "scaling_log", "rotation",
              *(("level", "extra_level") if cfg_j.is_lod else ())):
        np.testing.assert_array_equal(np.asarray(getattr(again, f))[:n],
                                      np.asarray(getattr(ast_j, f))[:n],
                                      err_msg=f)
    _, obj = read_ply(pt)
    assert obj == ([f"standard_dist {cfg_j.standard_dist:.6f}",
                    f"aerial_levels {cfg_j.aerial_levels:.6f}",
                    f"street_levels {cfg_j.street_levels:.6f}"]
                   if cfg_j.is_lod else [f"num_anchor {n:.6f}"])


def test_mlps_npz_both_directions(tmp_path):
    cfg_j, ts = _j_train_state(LOD)
    mlps = jopt.mlps_from_params(ts.params)
    jck.save_mlp_checkpoints(str(tmp_path / "j"), mlps)
    got = tck.load_mlp_checkpoints(str(tmp_path / "j"), device="cpu")
    for name in ("opacity", "cov", "color"):
        m = getattr(got, name)
        d = getattr(mlps, name)
        for t, key in ((m.w1, ("l1", "w")), (m.b1, ("l1", "b")),
                       (m.w2, ("l2", "w")), (m.b2, ("l2", "b"))):
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(d[key[0]][key[1]]))
    np.testing.assert_array_equal(got.appearance.detach().numpy(),
                                  np.asarray(mlps.appearance))
    tck.save_mlp_checkpoints(str(tmp_path / "t"), got)
    zj = np.load(tmp_path / "j" / "mlps.npz")
    zt = np.load(tmp_path / "t" / "mlps.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    back = jck.load_mlp_checkpoints(str(tmp_path / "t"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mlps)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _j_as_port_layout(ts):
    """A JAX `TrainState` in `convert.train_state_to_numpy`'s layout."""
    ts = _np(ts)

    def groups(tp):
        return {f: getattr(tp, f) for f in tp._fields}
    return {"params": groups(ts.params), "mu": groups(ts.opt.mu),
            "nu": groups(ts.opt.nu), "t": int(ts.opt.t),
            "stats": {f: getattr(ts.stats, f) for f in ts.stats._fields},
            "rotation": ts.rotation, "level": ts.level,
            "extra_level": ts.extra_level, "n": int(ts.n)}


@pytest.mark.parametrize("cfg_kw", [LOD, FLAT], ids=["lod", "flat"])
def test_train_checkpoint_both_directions(cfg_kw, tmp_path):
    _, ts = _j_train_state(cfg_kw, seed=3)
    pj, pt = str(tmp_path / "chkpnt_j.npz"), str(tmp_path / "chkpnt_t.npz")
    jck.save_train_checkpoint(pj, ts, 1234)
    got, it = tck.load_train_checkpoint(pj, device="cpu")
    assert it == 1234
    want = _flat(_j_as_port_layout(ts))
    have = _flat(train_state_to_numpy(got))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert got.params.anchor.requires_grad
    tck.save_train_checkpoint(pt, got, 1234)
    zj, zt = np.load(pj), np.load(pt)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    back, it2 = jck.load_train_checkpoint(pt, ts)
    assert it2 == 1234
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_search_max_iteration(tmp_path):
    for it in (7, 30000, 120):
        os.makedirs(tmp_path / f"iteration_{it}")
    assert (tck.search_max_iteration(str(tmp_path))
            == jck.search_max_iteration(str(tmp_path)) == 30000)
    assert tck.search_max_iteration(str(tmp_path / "none")) == -1


def _colmap_model(seed=0, n_img=4, n_pts=50):
    rng = np.random.default_rng(seed)
    cams = {1: tcol.ColmapCamera(1, "PINHOLE", 64, 48,
                                 np.array([60.0, 58.0, 32.0, 24.0])),
            2: tcol.ColmapCamera(2, "SIMPLE_PINHOLE", 40, 30,
                                 np.array([35.0, 20.0, 15.0]))}
    images = {}
    for i in range(1, n_img + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        # at least one observation: both packages' text readers drop
        # blank lines, so an image without points would misalign them
        n2d = int(rng.integers(1, 4))
        images[i] = tcol.ColmapImage(
            i, q, rng.normal(size=3), 1 + i % 2, f"img_{i:03d}.png",
            rng.uniform(0, 40, (n2d, 2)),
            rng.integers(-1, n_pts, n2d).astype(np.int64))
    xyz = rng.normal(size=(n_pts, 3))
    rgb = rng.integers(0, 256, (n_pts, 3)).astype(np.float64)
    err = rng.uniform(size=n_pts)
    return cams, images, xyz, rgb, err


def _write_text_model(d, cams, images, xyz, rgb, err):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            f.write(" ".join([str(im.id)]
                             + [repr(float(x)) for x in im.qvec]
                             + [repr(float(x)) for x in im.tvec]
                             + [str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3D_ids)) + "\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for i in range(xyz.shape[0]):
            f.write(" ".join([str(i + 1)]
                             + [repr(float(x)) for x in xyz[i]]
                             + [str(int(x)) for x in rgb[i]]
                             + [repr(float(err[i]))]) + "\n")


def _assert_models_equal(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys()
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == (
            cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (
            ib[k].id, ib[k].camera_id, ib[k].name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f), err_msg=f)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["binary", "text"])
def test_colmap_model_round_trip(kind, tmp_path):
    cams, images, xyz, rgb, err = _colmap_model()
    d = str(tmp_path / "sparse")
    if kind == "binary":
        tcol.write_model(cams, images, xyz, rgb, err, d)
        read = {p: (m.read_cameras_binary(os.path.join(d, "cameras.bin")),
                    m.read_images_binary(os.path.join(d, "images.bin")),
                    m.read_points3D_binary(os.path.join(d, "points3D.bin")))
                for p, m in (("t", tcol), ("j", jcol))}
        # the port's writer writes the JAX writer's bytes
        dj = str(tmp_path / "sparse_j")
        jcol.write_model(cams, images, xyz, rgb, err, dj)
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            with open(os.path.join(d, f), "rb") as a, \
                    open(os.path.join(dj, f), "rb") as b:
                assert a.read() == b.read(), f
    else:
        _write_text_model(d, cams, images, xyz, rgb, err)
        read = {p: (m.read_cameras_text(os.path.join(d, "cameras.txt")),
                    m.read_images_text(os.path.join(d, "images.txt")),
                    m.read_points3D_text(os.path.join(d, "points3D.txt")))
                for p, m in (("t", tcol), ("j", jcol))}
    _assert_models_equal(read["t"], read["j"])
    c, ims, (pxyz, prgb, perr) = read["t"]
    _assert_models_equal((c, ims, ()), (cams, images, ()))
    np.testing.assert_array_equal(pxyz, xyz)
    np.testing.assert_array_equal(prgb, rgb)
    np.testing.assert_array_equal(perr, err)
    for im in images.values():
        np.testing.assert_allclose(tcol.qvec2rotmat(im.qvec),
                                   jcol.qvec2rotmat(im.qvec), rtol=0, atol=0)
        np.testing.assert_allclose(
            tcol.rotmat2qvec(tcol.qvec2rotmat(im.qvec)),
            im.qvec * np.sign(im.qvec[0]), atol=1e-12)
