"""Port parity, core: transforms, SH, cameras and synthetic scenes against
the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.core import sh as jsh
from horizongs_tpu.core import transforms as jtf
from horizongs_tpu.data import synthetic as jsyn
from horizongs_tpu_torch.core import sh as tsh
from horizongs_tpu_torch.core import transforms as ttf
from horizongs_tpu_torch.data import synthetic as tsyn

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_transforms_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(257, 4)).astype(np.float32)
    np.testing.assert_allclose(ttf.normalize_quat(_t(q)).numpy(),
                               np.asarray(jtf.normalize_quat(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(ttf.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jtf.quat_to_rotmat(jnp.asarray(q))),
                               atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(300, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = np.asarray(jsh.eval_sh(degree, jnp.asarray(coeffs),
                                 jnp.asarray(dirs)))
    got = tsh.eval_sh(degree, _t(coeffs), _t(dirs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_random_gaussians_identical():
    a = jsyn.random_gaussians(500, seed=4, extent=0.7, scale_range=(0.02, 0.1))
    b = tsyn.random_gaussians(500, seed=4, extent=0.7, scale_range=(0.02, 0.1))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_cameras_identical():
    ja = jsyn.orbit_cameras(5, radius=3.5, height_z=-1.0, width=96, height=64)
    ta = tsyn.orbit_cameras(5, radius=3.5, height_z=-1.0, width=96, height=64,
                            device="cpu")
    for jc, tc in zip(ja, ta):
        np.testing.assert_array_equal(tc.viewmat.numpy(), np.asarray(jc.viewmat))
        np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
        np.testing.assert_array_equal(tc.cam_center.numpy(),
                                      np.asarray(jc.cam_center))
        assert (tc.width, tc.height, tc.uid) == (jc.width, jc.height, jc.uid)
    jl = jsyn.lookat_camera(width=50, height=38, eye=(0.3, -0.2, -4))
    tl = tsyn.lookat_camera(width=50, height=38, eye=(0.3, -0.2, -4),
                            device="cpu")
    np.testing.assert_array_equal(tl.viewmat.numpy(), np.asarray(jl.viewmat))
    np.testing.assert_array_equal(tl.K.numpy(), np.asarray(jl.K))


def test_transform_grads_match():
    """`normalize_quat` and `quat_to_rotmat` under autograd against
    `jax.grad`, with a seeded cotangent."""
    import jax
    rng = np.random.default_rng(1)
    q = rng.normal(size=(129, 4)).astype(np.float32)
    r_n = rng.normal(size=(129, 4)).astype(np.float32)
    r_r = rng.normal(size=(129, 3, 3)).astype(np.float32)

    def j_loss(q):
        return (jnp.sum(jtf.normalize_quat(q) * r_n)
                + jnp.sum(jtf.quat_to_rotmat(q) * r_r))

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(q)))
    qt = _t(q).requires_grad_(True)
    ((ttf.normalize_quat(qt) * _t(r_n)).sum()
     + (ttf.quat_to_rotmat(qt) * _t(r_r)).sum()).backward()
    np.testing.assert_allclose(qt.grad.numpy(), want, atol=1e-5, rtol=1e-5)
