"""Port parity, projection: `project_3dgs` and `project_2dgs` against the
JAX package, with near-plane and off-image culls in the inputs, values and
gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.ops.projection import project_2dgs as j_project2d
from horizongs_tpu.ops.projection import project_3dgs as j_project
from horizongs_tpu_torch.data.synthetic import lookat_camera as t_lookat
from horizongs_tpu_torch.ops.projection import project_2dgs as t_project2d
from horizongs_tpu_torch.ops.projection import project_3dgs as t_project

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _inputs(n=600, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3))
    # a slab beside the camera plane (z_cam <= near) and one far off-image
    means[:50, 2] = rng.uniform(-4.3, -3.995, 50)
    means[50:100, 0] = rng.uniform(8.0, 12.0, 50)
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.01, 0.3, (n, 3))
    return [a.astype(np.float32) for a in (means, quats, scales)]


@pytest.mark.parametrize("size", [(64, 64), (50, 38)])
def test_project_3dgs_matches(size):
    w, h = size
    means, quats, scales = _inputs()
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    jp = j_project(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                   jc.viewmat, jc.K, w, h)
    tp = t_project(torch.from_numpy(means), torch.from_numpy(quats),
                   torch.from_numpy(scales), tc.viewmat, tc.K, w, h)
    radii = np.asarray(jp.radii)
    np.testing.assert_array_equal(tp.radii.numpy(), radii)
    live = radii > 0
    # the culls really happened, and kept a majority
    assert (~live[:50]).all() and (~live[50:100]).all()
    assert live.sum() > 300
    np.testing.assert_allclose(tp.means2d.numpy()[live],
                               np.asarray(jp.means2d)[live], rtol=1e-5,
                               atol=1e-4)
    # rtol 1e-5, plus an atol of 1e-5 of each conic's largest entry: the
    # off-diagonal -b/det can come near 0 by cancellation
    jcon = np.asarray(jp.conics)[live]
    scale = np.abs(jcon).max(axis=1, keepdims=True)
    err = np.abs(tp.conics.numpy()[live] - jcon)
    assert (err <= 1e-5 * np.abs(jcon) + 1e-5 * scale).all(), err.max()
    np.testing.assert_allclose(tp.depths.numpy(), np.asarray(jp.depths),
                               rtol=1e-6, atol=1e-6)


def test_project_3dgs_grads_match():
    """Under autograd, against `jax.grad`: a seeded cotangent on the live
    gaussians' means2d and conics and on every depth, gradients w.r.t.
    means, quats and scales within 1e-4 x each column's max |grad|. (The
    cull mask feeds `torch.where` in the graph, so it is combined out of
    place: updated in place, it made this backward raise.)"""
    import jax
    w, h = 64, 64
    means, quats, scales = _inputs(n=300, seed=1)
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    live = np.asarray(j_project(jnp.asarray(means), jnp.asarray(quats),
                                jnp.asarray(scales), jc.viewmat, jc.K, w,
                                h).radii) > 0
    rng = np.random.default_rng(2)
    r_m = rng.normal(size=(300, 2)).astype(np.float32) * live[:, None]
    r_c = rng.normal(size=(300, 3)).astype(np.float32) * live[:, None]
    r_d = rng.normal(size=300).astype(np.float32)

    def j_loss(m, q, s):
        p = j_project(m, q, s, jc.viewmat, jc.K, w, h)
        return (jnp.sum(p.means2d * r_m) + jnp.sum(p.conics * r_c)
                + jnp.sum(p.depths * r_d))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (means, quats, scales)]
    p = t_project(*ts, tc.viewmat, tc.K, w, h)
    ((p.means2d * torch.from_numpy(r_m)).sum()
     + (p.conics * torch.from_numpy(r_c)).sum()
     + (p.depths * torch.from_numpy(r_d)).sum()).backward()
    for name, t, wj in zip(("means", "quats", "scales"), ts, want):
        wj = np.asarray(wj)
        err = np.abs(t.grad.numpy() - wj).max(axis=0)
        assert (err <= 1e-4 * np.abs(wj).max(axis=0)).all(), (name, err)


@pytest.mark.parametrize("size", [(64, 64), (50, 38)])
def test_project_2dgs_matches(size):
    """Surfels: radii equal (the 3σ-disk AABB with its |d| > 1e-10 and
    half² > 0 tests, the near and off-image culls), centres, depths, the
    transform M and the camera-facing normals within f32 rounding (rtol
    1e-5 plus 1e-5 of each row's largest entry: M's rows sum products of
    mixed size)."""
    w, h = size
    means, quats, scales = _inputs()
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    jp = j_project2d(jnp.asarray(means), jnp.asarray(quats),
                     jnp.asarray(scales), jc.viewmat, jc.K, w, h)
    tp = t_project2d(torch.from_numpy(means), torch.from_numpy(quats),
                     torch.from_numpy(scales), tc.viewmat, tc.K, w, h)
    radii = np.asarray(jp.radii)
    np.testing.assert_array_equal(tp.radii.numpy(), radii)
    live = radii > 0
    assert (~live[:50]).all() and (~live[50:100]).all()
    assert live.sum() > 300
    np.testing.assert_allclose(tp.means2d.numpy()[live],
                               np.asarray(jp.means2d)[live], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tp.depths.numpy(), np.asarray(jp.depths),
                               rtol=1e-6, atol=1e-6)
    jM = np.asarray(jp.transforms)
    scale = np.abs(jM).max(axis=2, keepdims=True)
    err = np.abs(tp.transforms.numpy() - jM)
    assert (err <= 1e-5 * np.abs(jM) + 1e-5 * scale).all(), err.max()
    jn = np.asarray(jp.normals)
    np.testing.assert_allclose(tp.normals.numpy(), jn, atol=1e-6)
    # every normal faces the camera: n . p_cam <= 0
    p_cam = (means @ tc.viewmat[:3, :3].numpy().T + tc.viewmat[:3, 3].numpy())
    assert ((tp.normals.numpy() * p_cam).sum(1) <= 1e-6).all()


def test_project_2dgs_grads_match():
    """Under autograd, against `jax.grad`: seeded cotangents on the live
    surfels' centres, transforms and normals and on every depth; gradients
    w.r.t. means, quats and scales within 1e-4 x each column's max |grad|."""
    import jax
    w, h = 64, 64
    means, quats, scales = _inputs(n=300, seed=1)
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    live = np.asarray(j_project2d(jnp.asarray(means), jnp.asarray(quats),
                                  jnp.asarray(scales), jc.viewmat, jc.K, w,
                                  h).radii) > 0
    rng = np.random.default_rng(3)
    r_m = rng.normal(size=(300, 2)).astype(np.float32) * live[:, None]
    r_t = (rng.normal(size=(300, 3, 3)).astype(np.float32)
           * live[:, None, None])
    r_n = rng.normal(size=(300, 3)).astype(np.float32) * live[:, None]
    r_d = rng.normal(size=300).astype(np.float32)

    def j_loss(m, q, s):
        p = j_project2d(m, q, s, jc.viewmat, jc.K, w, h)
        return (jnp.sum(p.means2d * r_m) + jnp.sum(p.transforms * r_t)
                + jnp.sum(p.normals * r_n) + jnp.sum(p.depths * r_d))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (means, quats, scales)]
    p = t_project2d(*ts, tc.viewmat, tc.K, w, h)
    ((p.means2d * torch.from_numpy(r_m)).sum()
     + (p.transforms * torch.from_numpy(r_t)).sum()
     + (p.normals * torch.from_numpy(r_n)).sum()
     + (p.depths * torch.from_numpy(r_d)).sum()).backward()
    for name, t, wj in zip(("means", "quats", "scales"), ts, want):
        wj = np.asarray(wj)
        err = np.abs(t.grad.numpy() - wj).max(axis=0)
        assert (err <= 1e-4 * np.abs(wj).max(axis=0)).all(), (name, err)
