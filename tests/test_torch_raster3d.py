"""Port parity, K1: the plain version against the JAX kernel (Pallas in
interpret mode) on the same instance data, and the CUDA-path wrapper
against `rasterize_pallas_3dgs(interpret=True)`. Tolerances are those of
`tests/test_raster_pallas.py`: renders atol 1e-4 with rtol 2e-4 (the ED
depth channel), alphas atol 2e-5; the final transmittance compares as
exp(logT) within 1e-4, since past the stop the JAX kernel keeps adding the
rest of its chunk pair to log T while the port stops at the pixel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.data.synthetic import random_gaussians
from horizongs_tpu.ops.pallas.raster3d import rasterize_fwd as j_fwd
from horizongs_tpu.ops.raster_pallas import rasterize_pallas_3dgs
from horizongs_tpu_torch.data.synthetic import lookat_camera as t_lookat
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops.raster_cuda import rasterize_cuda_3dgs

G = raster3d.G


def _instance_data(seed=0):
    """Random (N, 10) fields and hand-made segments over a 3x2 tile grid:
    one empty tile, short ones, and a long opaque one that saturates
    before its segment ends."""
    rng = np.random.default_rng(seed)
    ntx, nty = 3, 2
    counts = [0, 37, 300, 5, 700, 128]
    n = 400
    f = np.zeros((n, 10), np.float32)
    f[:, 0] = rng.uniform(-8, 3 * 32 + 8, n)
    f[:, 1] = rng.uniform(-8, 2 * 32 + 8, n)
    s = rng.uniform(0.002, 0.05, (n, 2))            # inverse variances
    rho = rng.uniform(-0.6, 0.6, n)
    f[:, 2], f[:, 4] = s[:, 0], s[:, 1]
    f[:, 3] = rho * np.sqrt(s[:, 0] * s[:, 1])
    f[:, 5] = rng.uniform(0.2, 0.99, n)
    f[:, 6:9] = rng.uniform(0, 1, (n, 3))
    f[:, 9] = rng.uniform(1, 6, n)
    ids = []
    for t, c in enumerate(counts):
        g = rng.integers(0, n, c)
        if t == 4:       # the opaque stack over tile 4: wide, centred, dense
            f[g, 0] = rng.uniform(32, 64, c)
            f[g, 1] = rng.uniform(32, 64, c)
            f[g, 2] = f[g, 4] = 0.002
            f[g, 3] = 0.0
            f[g, 5] = 0.97
        ids.append(g)
    gauss_id = np.concatenate(ids).astype(np.int32)
    tile_starts = np.r_[0, np.cumsum(counts)].astype(np.int32)
    return f, gauss_id, tile_starts, ntx, nty


def _jax_inst(fields, gauss_id):
    """The JAX kernel's (16, CAP+2G) transposed instance buffer."""
    cap = -(-gauss_id.shape[0] // G) * G
    inst = np.zeros((16, cap + 2 * G), np.float32)
    inst[:10, :gauss_id.shape[0]] = fields[gauss_id].T
    inst[10, :gauss_id.shape[0]] = 1.0
    return inst


def test_plain_matches_jax_kernel():
    f, gid, starts, ntx, nty = _instance_data()
    acc, logT = raster3d.rasterize_fwd_plain(
        torch.from_numpy(f), torch.from_numpy(gid), torch.from_numpy(starts),
        ntx, nty)
    j_acc, j_logT = j_fwd(jnp.asarray(_jax_inst(f, gid)),
                          jnp.asarray(starts), ntx, nty, interpret=True)
    j_acc, j_logT = np.asarray(j_acc), np.asarray(j_logT)
    np.testing.assert_allclose(acc[:, 0:3].numpy(), j_acc[:, 6:9], atol=1e-4)
    np.testing.assert_allclose(acc[:, 3].numpy(), j_acc[:, 9], atol=1e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(acc[:, 4].numpy(), j_acc[:, 10], atol=2e-5)
    np.testing.assert_allclose(np.exp(logT[:, 0].numpy()),
                               np.exp(j_logT[:, 0]), atol=1e-4)
    i_fin = logT[:, 1, 0].numpy()
    n_chunks = -(-np.diff(starts) // G)
    assert i_fin[0] == 0 and (logT[0, 0] == 0).all()    # empty tile
    assert (acc[0] == 0).all()
    assert i_fin[4] < n_chunks[4]                        # stopped early
    np.testing.assert_array_equal(np.delete(i_fin, 4),
                                  np.delete(n_chunks, 4))
    assert (logT[4, 0] <= raster3d.LOG_T_EPS).all()


def _scene(n=64, seed=1, w=64, h=64):
    g = random_gaussians(n, seed=seed, extent=0.8, scale_range=(0.03, 0.12))
    return g, j_lookat(width=w, height=h, eye=(0, 0, -4)), \
        t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")


def _stack(n=400, seed=7):
    """`test_raster_pallas`'s saturated stack: ~3 chunks in depth over
    the same few tiles."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n),
                      np.linspace(-0.5, 0.5, n)], axis=1).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return {"means": means, "quats": quats,
            "scales": np.full((n, 3), 0.08, np.float32),
            "opacities": np.full((n,), 0.95, np.float32),
            "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32)}


def _compare(g, jc, tc, w, h, mode, cap=None):
    keys = ("means", "quats", "scales", "opacities", "colors")
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    r_j, a_j, i_j = rasterize_pallas_3dgs(
        *(jnp.asarray(g[k]) for k in keys), jc.viewmat, jc.K, w, h,
        jnp.asarray(bg), render_mode=mode, cap=cap, interpret=True)
    r_t, a_t, i_t = rasterize_cuda_3dgs(
        *(torch.from_numpy(g[k]) for k in keys), tc.viewmat, tc.K, w, h,
        torch.from_numpy(bg), render_mode=mode, cap=cap)
    assert r_t.shape == r_j.shape and a_t.shape == a_j.shape
    assert int(i_t["n_instances"]) == int(i_j["n_instances"])
    assert int(i_t["n_dropped"]) == int(i_j["n_dropped"])
    assert set(i_t) == set(i_j)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=2e-5)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-4,
                               rtol=2e-4)
    return i_t


@pytest.mark.parametrize("mode", ["RGB", "RGB+D", "RGB+ED"])
def test_wrapper_matches_pallas_nonmultiple(mode):
    g, jc, tc = _scene(w=50, h=38)
    _compare(g, jc, tc, 50, 38, mode)


def test_wrapper_matches_pallas_saturated_stack():
    g = _stack()
    _, jc, tc = _scene()
    _compare(g, jc, tc, 64, 64, "RGB+ED")


def test_wrapper_matches_pallas_opacity_cull():
    g, jc, tc = _scene()
    g["opacities"][::2] = 1e-4
    _compare(g, jc, tc, 64, 64, "RGB")


def test_wrapper_overflow_counted():
    g, jc, tc = _scene(n=200)
    info = _compare(g, jc, tc, 64, 64, "RGB", cap=256)
    assert int(info["n_dropped"]) > 0


def test_wrapper_refuses_grad_and_bad_inputs():
    g, _, tc = _scene(n=8)
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    t["means"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="training slice"):
        rasterize_cuda_3dgs(t["means"], t["quats"], t["scales"],
                            t["opacities"], t["colors"], tc.viewmat, tc.K,
                            64, 64, torch.zeros(3))
    f, gid, starts, ntx, nty = _instance_data()
    good = (torch.from_numpy(f), torch.from_numpy(gid),
            torch.from_numpy(starts))
    bad_cases = [
        (good[0].double(), good[1], good[2]),
        (good[0], good[1].long(), good[2]),
        (good[0][:, :9].contiguous(), good[1], good[2]),
        (good[0].T.contiguous().T, good[1], good[2]),
        (good[0], good[1], good[2][:-1]),
    ]
    for args in bad_cases:
        with pytest.raises(ValueError):
            raster3d.rasterize_fwd(*args, ntx, nty)

