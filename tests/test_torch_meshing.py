"""The port's meshing and path utilities against the JAX package's on the
CPU: `fuse_tsdf` and `fuse_tsdf_contracted` on the same depth maps of an
analytic sphere (float32 depths, as renders give) within 1e-9 and the
same weights; the sphere cases of `tests/test_meshing.py` on the port's
functions; `transform_poses_pca`, `generate_ellipse_path` and
`generate_path_cameras` against `utils/render_paths.py` within 1e-9."""
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import orbit_cameras as j_orbit
from horizongs_tpu.utils import meshing as jm
from horizongs_tpu.utils import render_paths as jrp
from horizongs_tpu_torch.data.synthetic import orbit_cameras
from horizongs_tpu_torch.utils import meshing as tm
from horizongs_tpu_torch.utils import render_paths as trp
from test_meshing import _sphere_depth

torch.set_num_threads(1)

RADIUS = 0.8


def _views(size=64):
    """Depth maps (float32, as a render gives them), alphas, viewmats, Ks
    and centres of 16 cameras around a sphere of radius 0.8."""
    cams = (j_orbit(8, radius=3.0, height_z=0.0, width=size, height=size)
            + j_orbit(4, radius=3.0, height_z=-2.0, width=size, height=size)
            + j_orbit(4, radius=3.0, height_z=2.0, width=size, height=size))
    out = {"depths": [], "alphas": [], "viewmats": [], "Ks": [],
           "centers": []}
    for cam in cams:
        d, a = _sphere_depth(cam, RADIUS)
        out["depths"].append(d.astype(np.float32))
        out["alphas"].append(a.astype(np.float32))
        out["viewmats"].append(np.asarray(cam.viewmat))
        out["Ks"].append(np.asarray(cam.K))
        out["centers"].append(np.asarray(cam.cam_center))
    return out


@pytest.fixture(scope="module")
def views():
    return _views()


def test_fuse_tsdf_matches_jax(views):
    v = views
    voxel, half = 0.05, 1.2
    # a float32 origin, as `export_mesh` derives it from the camera centres
    origin = np.full(3, -half, np.float32)
    dims = (int(2 * half / voxel),) * 3
    args = (v["depths"], v["alphas"], v["viewmats"], v["Ks"], origin, voxel,
            dims, 5 * voxel, 10.0)
    tj, wj = jm.fuse_tsdf(*args)
    tt, wt = tm.fuse_tsdf(*args, device="cpu")
    assert tt.dtype == tj.dtype == np.float64
    np.testing.assert_array_equal(wt, wj)
    assert (wj > 0).sum() > 1000
    np.testing.assert_allclose(tt, tj, atol=1e-9, rtol=0)
    # the depth maps as tensors give the same grid
    depths = [torch.tensor(d) for d in v["depths"]]
    viewmats = [torch.tensor(m) for m in v["viewmats"]]
    tt2, _ = tm.fuse_tsdf(depths, v["alphas"], viewmats, v["Ks"], origin,
                          voxel, dims, 5 * voxel, 10.0, device="cpu")
    np.testing.assert_array_equal(tt2, tt)


def test_fuse_tsdf_contracted_matches_jax(views):
    v = views
    center, radius = jm.estimate_bounding_sphere(np.array(v["centers"]))
    args = (v["depths"], v["alphas"], v["viewmats"], v["Ks"], center, radius)
    tj, wj, oj, vj = jm.fuse_tsdf_contracted(*args, resolution=48)
    tt, wt, ot, vt = tm.fuse_tsdf_contracted(*args, resolution=48,
                                             device="cpu")
    assert tt.dtype == tj.dtype and vt == vj
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(wt, wj)
    assert (wj > 0).sum() > 1000
    np.testing.assert_allclose(tt, tj, atol=1e-9, rtol=0)


def test_tsdf_sphere_reconstruction():
    v = _views(96)
    voxel, half = 0.05, 1.2
    origin = np.array([-half, -half, -half])
    dims = (int(2 * half / voxel),) * 3
    tsdf, weight = tm.fuse_tsdf(v["depths"], v["alphas"], v["viewmats"],
                                v["Ks"], origin, voxel, dims,
                                sdf_trunc=5 * voxel, depth_trunc=10.0,
                                device="cpu")
    assert (weight > 0).any()
    verts, faces = tm.marching_tetrahedra(tsdf, weight, origin, voxel)
    assert verts.shape[0] > 100 and faces.shape[0] > 100
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - RADIUS) < 2.5 * voxel
    assert np.quantile(np.abs(r - RADIUS), 0.9) < 4 * voxel
    verts2, faces2 = tm.largest_component(verts, faces)
    assert faces2.shape[0] <= faces.shape[0] and verts2.shape[0] > 50


def test_unbounded_contract_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 3)) * 3.0
    y = tm.contract(x)
    assert np.linalg.norm(y, axis=-1).max() < 2.0
    np.testing.assert_allclose(tm.uncontract(y), x, rtol=1e-5, atol=1e-5)
    xin = rng.normal(size=(100, 3)) * 0.3
    np.testing.assert_allclose(tm.contract(xin), xin, atol=1e-12)


def test_unbounded_tsdf_sphere_reconstruction():
    v = _views(96)
    verts, faces = tm.extract_mesh_unbounded(
        v["depths"], v["alphas"], v["viewmats"], v["Ks"],
        np.array(v["centers"]), resolution=96, device="cpu")
    assert verts.shape[0] > 100 and faces.shape[0] > 100
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - RADIUS) < 0.12
    assert np.quantile(np.abs(r - RADIUS), 0.9) < 0.2


def test_mesh_ply_roundtrip(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    p = str(tmp_path / "m.ply")
    tm.write_mesh_ply(p, verts, faces)
    v2, f2 = jm.read_mesh_ply(p)        # the JAX package reads it too
    np.testing.assert_allclose(v2, verts, atol=1e-6)
    np.testing.assert_array_equal(f2, faces)
    v3, f3 = tm.read_mesh_ply(p)
    np.testing.assert_array_equal(v3, v2)
    np.testing.assert_array_equal(f3, f2)


def test_marching_tets_analytic_sphere_sdf():
    n = 40
    xs = np.linspace(-1, 1, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    r = 0.6
    sdf = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r
    voxel = xs[1] - xs[0]
    origin = np.full(3, -1 - voxel / 2)
    verts, faces = tm.marching_tetrahedra(sdf.astype(np.float32), None,
                                          origin, voxel)
    assert verts.shape[0] > 200
    assert np.abs(np.linalg.norm(verts, axis=1) - r).max() < voxel


def test_render_paths_match_jax():
    cams = orbit_cameras(10, radius=4.0, height_z=-1.5, width=32, height=24,
                         device="cpu")
    c2w = np.array([np.linalg.inv(c.viewmat.numpy()) for c in cams])[:, :3]
    pj, tfj = jrp.transform_poses_pca(c2w)
    pt, tft = trp.transform_poses_pca(c2w)
    np.testing.assert_allclose(pt, pj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tft, tfj, atol=1e-9, rtol=0)
    ej = jrp.generate_ellipse_path(pj, n_frames=12)
    et = trp.generate_ellipse_path(pt, n_frames=12)
    np.testing.assert_allclose(et, ej, atol=1e-9, rtol=0)
    jcams = j_orbit(10, radius=4.0, height_z=-1.5, width=32, height=24)
    path_j = jrp.generate_path_cameras(jcams, n_frames=12)
    path_t = trp.generate_path_cameras(cams, n_frames=12)
    assert len(path_t) == len(path_j) == 12
    for a, b in zip(path_t, path_j):
        np.testing.assert_array_equal(a.viewmat.numpy(),
                                      np.asarray(b.viewmat))
        np.testing.assert_array_equal(a.cam_center.numpy(),
                                      np.asarray(b.cam_center))
        np.testing.assert_array_equal(a.K.numpy(), np.asarray(b.K))
        assert (a.width, a.height, a.image) == (32, 24, None)
