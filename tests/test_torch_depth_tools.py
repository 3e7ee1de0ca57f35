"""Port parity, depth preprocessing: `data/depth_tools.py` and
`cli/generate_depth.py` against the JAX package's. Both are host numpy:
each function at rtol 1e-12 on seeded inputs (invalid depths, unknown
point ids and the too-few-points fit included), and `--fit-scales` on a
COLMAP binary model written with the port's writers plus `.npy` inverse
depth maps writes the same `depth_params.json` byte for byte. The network
backends use only weights already on the machine: `--backend onnx` with
no `--model` returns 1, with a missing file 2."""
import os

import numpy as np
import pytest
from PIL import Image

from horizongs_tpu.cli.generate_depth import main as j_depth_main
from horizongs_tpu.data import depth_tools as jdt
from horizongs_tpu_torch.cli.generate_depth import main as t_depth_main
from horizongs_tpu_torch.data import depth_tools as tdt
from horizongs_tpu_torch.data.colmap import (
    ColmapCamera,
    ColmapImage,
    qvec2rotmat,
    rotmat2qvec,
    write_model,
)

W, H = 40, 30
K = np.array([[35.0, 0.0, 20.0], [0.0, 35.0, 15.0], [0.0, 0.0, 1.0]])


def _close(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=0)
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _c2w(rng):
    a = rng.normal(size=3)
    R = qvec2rotmat(np.r_[1.0, 0.2 * a] / np.linalg.norm(np.r_[1.0, 0.2 * a]))
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = R, rng.normal(size=3)
    return c2w


@pytest.mark.parametrize("stride, max_depth, depth_scale",
                         [(1, np.inf, 1.0), (2, 4.0, 0.01), (3, 9.0, 2.5)])
def test_depth_to_points_matches(stride, max_depth, depth_scale):
    rng = np.random.default_rng(stride)
    depth = rng.uniform(0.5, 8.0, (H, W)) / depth_scale
    depth[0, :5] = 0.0
    depth[3, 3] = np.inf
    depth[5, 7] = np.nan
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    c2w = _c2w(rng)
    got = tdt.depth_to_points(depth, K, c2w, rgb=rgb, max_depth=max_depth,
                              stride=stride, depth_scale=depth_scale)
    want = jdt.depth_to_points(depth, K, c2w, rgb=rgb, max_depth=max_depth,
                               stride=stride, depth_scale=depth_scale)
    for a, b in zip(got, want):
        _close(a, b)
    assert 0 < got[0].shape[0] < (H // stride + 1) * (W // stride + 1)
    with np.errstate(divide="ignore"):
        inv = np.where(np.isfinite(depth) & (depth > 0), 1.0 / depth, 0.0)
    for a, b in zip(tdt.invdepth_to_points(inv, K, c2w, stride=stride),
                    jdt.invdepth_to_points(inv, K, c2w, stride=stride)):
        _close(a, b)


def _observations(rng, n_pts=60, n_obs=45):
    xyz = rng.uniform(-1, 1, (n_pts, 3)) + [0, 0, 5]
    ids = np.arange(1, n_pts + 1)
    viewmat = np.eye(4)
    viewmat[:3, 3] = rng.normal(scale=0.1, size=3)
    pick = rng.choice(n_pts, n_obs, replace=False)
    p = xyz[pick] @ viewmat[:3, :3].T + viewmat[:3, 3]
    uv = p @ K.T
    xys = uv[:, :2] / uv[:, 2:]
    pids = ids[pick].copy()
    pids[:4] = -1                          # untriangulated observations
    pids[4] = 10_000                       # an id the model lacks
    return xys, pids, xyz, ids, viewmat


def test_fit_invdepth_scale_matches():
    rng = np.random.default_rng(0)
    xys, pids, xyz, ids, viewmat = _observations(rng)
    got = tdt.sparse_depths_for_image(xys, pids, xyz, ids, viewmat)
    want = jdt.sparse_depths_for_image(xys, pids, xyz, ids, viewmat)
    for a, b in zip(got, want):
        _close(a, b)
    assert got[1].shape == (40,)
    mono = rng.uniform(0.1, 0.3, (H, W))
    fit = tdt.fit_invdepth_scale(mono, *got)
    assert fit.keys() == {"scale", "offset", "n"} and fit["n"] == 40
    want_fit = jdt.fit_invdepth_scale(mono, *want)
    for k in ("scale", "offset"):
        np.testing.assert_allclose(fit[k], want_fit[k], rtol=1e-12)
    # too few observations with a depth
    few = tdt.fit_invdepth_scale(mono, got[0][:4], got[1][:4])
    assert few == jdt.fit_invdepth_scale(mono, got[0][:4], got[1][:4]) == \
        {"scale": 0.0, "offset": 0.0, "n": 4}
    assert [a.shape for a in tdt.sparse_depths_for_image(
        xys, -np.ones_like(pids), xyz, ids, viewmat)] == [(0, 2), (0,)]


def _colmap_dataset(root):
    """A COLMAP model of 4 images (one with 6 observations, one without a
    depth map) and each image's inverse depth map as depths/<name>.npy."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, (80, 3)) + [0, 0, 5]
    cams = {1: ColmapCamera(1, "PINHOLE", W, H,
                            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    images = {}
    os.makedirs(os.path.join(root, "depths"))
    os.makedirs(os.path.join(root, "images"))
    for i, n_obs in enumerate((50, 40, 6, 30), start=1):
        R = _c2w(rng)[:3, :3]
        t = rng.normal(scale=0.2, size=3)
        pick = np.sort(rng.choice(80, n_obs, replace=False))
        p = xyz[pick] @ R.T + t
        uv = p @ K.T
        name = f"img_{i}.png"
        images[i] = ColmapImage(i, rotmat2qvec(R), t, 1, name,
                                uv[:, :2] / uv[:, 2:], pick + 1)
        Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(
            os.path.join(root, "images", name))
        if i != 4:
            inv = (rng.uniform(0.15, 0.25) + 0.02 * rng.normal(size=(H, W)))
            np.save(os.path.join(root, "depths", f"img_{i}.npy"),
                    inv.astype(np.float32))
    write_model(cams, images, xyz, np.full((80, 3), 0.5), np.zeros(80),
                os.path.join(root, "sparse", "0"))
    return os.path.join(root, "sparse", "0", "depth_params.json")


def test_fit_scales_cli_matches(tmp_path, capsys):
    root = str(tmp_path / "scene")
    out = _colmap_dataset(root)
    written = {}
    for name, main in (("j", j_depth_main), ("t", t_depth_main)):
        assert main(["-s", root, "--fit-scales"]) == 0
        with open(out, "rb") as f:
            written[name] = f.read()
        os.remove(out)
    assert written["t"] == written["j"]
    assert b"img_1" in written["t"] and b"img_2" in written["t"]
    assert b"img_3" not in written["t"] and b"img_4" not in written["t"]
    assert "wrote" in capsys.readouterr().out


def test_onnx_backend_needs_a_local_model(tmp_path, capsys):
    root = str(tmp_path / "scene")
    _colmap_dataset(root)
    assert t_depth_main(["-s", root, "--backend", "onnx"]) == 1
    assert "--backend onnx requires --model" in capsys.readouterr().err
    assert t_depth_main(["-s", root, "--backend", "onnx", "--model",
                         str(tmp_path / "none.onnx")]) == 2
    assert "depth backend unavailable" in capsys.readouterr().err
    assert t_depth_main(["-s", str(tmp_path / "empty")]) == 1
