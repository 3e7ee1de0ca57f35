"""Port parity, projection: `project_3dgs` against the JAX package, with
near-plane and off-image culls in the inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.ops.projection import project_3dgs as j_project
from horizongs_tpu_torch.data.synthetic import lookat_camera as t_lookat
from horizongs_tpu_torch.ops.projection import project_3dgs as t_project


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
