"""The JAX package's external anchors (`tests/test_goldens.py`) held on the
port: the closed-form 3DGS (one splat and a stack of three on the optical
axis) and 2DGS (one camera-facing surfel) renders, and the committed
pinned-scene golden `tests/goldens/scene32.npz` (render, alphas and the
gradients of means, scales, opacities and colors), read and never
regenerated. Each holds the port's dense oracle and its compositing path
on CPU tensors (the plain K1/K2 and K3), at the JAX tests' tolerances:
atol 1e-4 (3DGS) and 2e-4 (2DGS, the npz; gradients 2e-4 x each one's
max). `tests/test_torch_cuda.py::test_goldens_through_kernels` puts K1/K2
and K3 on the card through the same goldens.

The closed forms are float64 numpy copies of `tests/test_goldens.py`'s, so
that the card's test file needs no JAX;
`test_closed_forms_are_the_jax_tests` holds the copies to the originals.
"""
import os

import numpy as np
import pytest
import torch

from horizongs_tpu_torch.data.synthetic import lookat_camera, random_gaussians
from horizongs_tpu_torch.ops.raster_cuda import (
    rasterize_cuda_2dgs,
    rasterize_cuda_3dgs,
)
from horizongs_tpu_torch.ops.reference import (
    render_dense_2dgs,
    render_dense_3dgs,
)

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "scene32.npz")
W = H = 64
BACKENDS_3D = {"dense": render_dense_3dgs, "plain": rasterize_cuda_3dgs}
BACKENDS_2D = {"dense": render_dense_2dgs, "plain": rasterize_cuda_2dgs}


def center_cam(device="cpu"):
    return lookat_camera(width=W, height=H, eye=(0.0, 0.0, -4.0),
                         device=device)


def analytic_isotropic(cam, zs, scales, opacities, colors, bg, eps2d=0.3):
    """Exact render of gaussians on the optical axis (isotropic screen
    covariance (f s / z)^2 + eps2d), composited front to back in float64
    (`tests/test_goldens.py::_analytic_isotropic`)."""
    fx = float(cam.K[0, 0])
    cx, cy = float(cam.K[0, 2]), float(cam.K[1, 2])
    px = np.arange(W, dtype=np.float64) + 0.5
    py = np.arange(H, dtype=np.float64) + 0.5
    d2 = (px[None, :] - cx) ** 2 + (py[:, None] - cy) ** 2
    T = np.ones((H, W))
    color = np.zeros((H, W, 3))
    alpha_sum = np.zeros((H, W))
    for i in np.argsort(zs):
        var = (fx * scales[i] / zs[i]) ** 2 + eps2d
        a = np.minimum(opacities[i] * np.exp(-0.5 * d2 / var), 0.999)
        a = np.where(a >= 1.0 / 255.0, a, 0.0)
        w = np.where(T > 1e-4, a * T, 0.0)
        color += w[..., None] * np.asarray(colors[i])[None, None, :]
        alpha_sum += w
        T = T * np.where(w > 0, 1.0 - a, 1.0)
    return color + T[..., None] * np.asarray(bg)[None, None, :], alpha_sum


def axis_scene(n, base_z=4.0, dz=0.5, s=0.25):
    """n isotropic gaussians strung along the optical axis
    (`tests/test_goldens.py::_axis_scene`)."""
    zs = np.array([base_z + dz * (i - (n - 1) / 2) for i in range(n)])
    means = np.stack([np.zeros(n), np.zeros(n), zs - 4.0], axis=-1)
    quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
    scales = np.full((n, 3), s)
    opac = np.linspace(0.6, 0.9, n)
    colors = np.linspace([0.9, 0.2, 0.1], [0.1, 0.4, 0.9], n)
    return zs, means, quats, scales, opac, colors


def analytic_surfel(cam, z, s0, s1, opacity, color, bg):
    """Exact render of one camera-facing surfel at depth z with the
    screen-space low-pass min(rho3d, 2 d^2)
    (`tests/test_goldens.py::_analytic_2dgs_surfel`)."""
    fx, fy = float(cam.K[0, 0]), float(cam.K[1, 1])
    cx, cy = float(cam.K[0, 2]), float(cam.K[1, 2])
    dx = np.arange(W, dtype=np.float64)[None, :] + 0.5 - cx
    dy = np.arange(H, dtype=np.float64)[:, None] + 0.5 - cy
    u = dx * z / fx / s0
    v = dy * z / fy / s1
    rho = np.minimum(u * u + v * v, 2.0 * (dx * dx + dy * dy))
    a = np.minimum(opacity * np.exp(-0.5 * rho), 0.999)
    a = np.where(a >= 1.0 / 255.0, a, 0.0)
    render = (a[..., None] * np.asarray(color)[None, None, :]
              + (1.0 - a)[..., None] * np.asarray(bg)[None, None, :])
    return render, a


SURFEL = dict(s0=0.35, s1=0.2, z=4.0, op=0.85, color=(0.7, 0.3, 0.5),
              bg=(0.1, 0.2, 0.3))
BG_3D = (0.15, 0.25, 0.35)


def _t(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def check_analytic_3dgs(fn, n, dev):
    cam = center_cam(dev)
    zs, means, quats, scales, opac, colors = axis_scene(n)
    golden, golden_alpha = analytic_isotropic(cam, zs, scales[:, 0], opac,
                                              colors, BG_3D)
    out = fn(_t(means, dev), _t(quats, dev), _t(scales, dev), _t(opac, dev),
             _t(colors, dev), cam.viewmat, cam.K, W, H, _t(BG_3D, dev))
    if isinstance(out[-1], dict) and "n_dropped" in out[-1]:
        assert int(out[-1]["n_dropped"]) == 0
    np.testing.assert_allclose(out[0].cpu().numpy(), golden, atol=1e-4)
    np.testing.assert_allclose(out[1].cpu().numpy()[..., 0], golden_alpha,
                               atol=1e-4)


def check_analytic_2dgs(fn, dev):
    cam = center_cam(dev)
    s = SURFEL
    golden, golden_alpha = analytic_surfel(cam, s["z"], s["s0"], s["s1"],
                                           s["op"], s["color"], s["bg"])
    out = fn(torch.zeros((1, 3), device=dev),
             _t([[1.0, 0.0, 0.0, 0.0]], dev),
             _t([[s["s0"], s["s1"], 1.0]], dev), _t([s["op"]], dev),
             _t([s["color"]], dev), cam.viewmat, cam.K, W, H,
             _t(s["bg"], dev))
    np.testing.assert_allclose(out[0].cpu().numpy(), golden, atol=2e-4)
    np.testing.assert_allclose(out[1].cpu().numpy()[..., 0], golden_alpha,
                               atol=2e-4)


def check_pinned_scene(fn, dev):
    """Render, alphas and the gradients of mean((render - 0.5)^2) with
    respect to means, scales, opacities and colors of the pinned 32x32
    scene against the committed file."""
    gold = np.load(GOLDEN_PATH)
    cam = lookat_camera(width=32, height=32, eye=(0.4, -0.3, -3.6),
                        device=dev)
    g = {k: _t(v, dev) for k, v in random_gaussians(
        64, seed=7, extent=0.8, scale_range=(0.04, 0.15)).items()}
    leaves = [g[k].requires_grad_() for k in ("means", "scales",
                                              "opacities", "colors")]
    render, alphas = fn(g["means"], g["quats"], g["scales"], g["opacities"],
                        g["colors"], cam.viewmat, cam.K, 32, 32,
                        _t([0.2, 0.3, 0.4], dev))[:2]
    grads = torch.autograd.grad(torch.mean((render - 0.5) ** 2), leaves)
    np.testing.assert_allclose(render.detach().cpu().numpy(),
                               gold["render"], atol=2e-4)
    np.testing.assert_allclose(alphas.detach().cpu().numpy(),
                               gold["alphas"], atol=2e-4)
    for name, got in zip(("means", "scales", "opacities", "colors"), grads):
        want = gold[f"grad_{name}"]
        scale = np.abs(want).max() or 1.0
        np.testing.assert_allclose(got.cpu().numpy(), want,
                                   atol=2e-4 * scale, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS_3D)
@pytest.mark.parametrize("n", [1, 3])
def test_analytic_3dgs(backend, n):
    check_analytic_3dgs(BACKENDS_3D[backend], n, "cpu")


@pytest.mark.parametrize("backend", BACKENDS_2D)
def test_analytic_2dgs(backend):
    check_analytic_2dgs(BACKENDS_2D[backend], "cpu")


@pytest.mark.parametrize("backend", BACKENDS_3D)
def test_pinned_scene_golden(backend):
    check_pinned_scene(BACKENDS_3D[backend], "cpu")


def test_closed_forms_are_the_jax_tests():
    """The copies above compute what `tests/test_goldens.py`'s closed forms
    compute, on its scenes and camera (imported here, in the body: the
    card's test file imports this module without JAX)."""
    import test_goldens as jg
    cam, jcam = center_cam(), jg._center_cam()
    np.testing.assert_array_equal(cam.K.numpy(), np.asarray(jcam.K))
    np.testing.assert_array_equal(cam.viewmat.numpy(),
                                  np.asarray(jcam.viewmat))
    for n in (1, 3):
        scene, jscene = axis_scene(n), jg._axis_scene(n)
        for a, b in zip(scene, jscene):
            np.testing.assert_array_equal(a, b)
        zs, _, _, scales, opac, colors = scene
        for a, b in zip(
                analytic_isotropic(cam, zs, scales[:, 0], opac, colors,
                                   BG_3D),
                jg._analytic_isotropic(jcam, zs, scales[:, 0], opac, colors,
                                       np.array(BG_3D))):
            np.testing.assert_array_equal(a, b)
    s = SURFEL
    args = (s["z"], s["s0"], s["s1"], s["op"], np.array(s["color"]),
            np.array(s["bg"]))
    for a, b in zip(analytic_surfel(cam, *args),
                    jg._analytic_2dgs_surfel(jcam, *args)):
        np.testing.assert_array_equal(a, b)
