"""Port parity, binning: the forward fields of `build_tile_instances`
against the JAX package on identical projected inputs, with ties (ten
copies of a gaussian at one mean and depth, as zero offsets give) and an
overflowing capacity; the ellipse path (3DGS, 32x32 tiles) and the circle
path (2DGS surfels, 32x16 tiles, the guarded cull radius)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera
from horizongs_tpu.ops import binning as jb
from horizongs_tpu.ops.projection import project_2dgs, project_3dgs
from horizongs_tpu_torch.ops import binning as tb

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

W, H, TILE = 96, 80, 32


def _projected(n=300, seed=2, copies=10, surfels=False):
    """Projected gaussians as numpy (means2d, radii, depths, conics,
    opacities); the first 20 are repeated `copies` times. `surfels`: the
    2DGS projection and cull radius (conics None)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.9, 0.9, (n, 3))
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.02, 0.15, (n, 3))
    op = rng.uniform(0.02, 0.95, n)
    rep = np.r_[np.repeat(np.arange(20), copies), np.arange(20, n)]
    means, quats, scales, op = (a[rep].astype(np.float32)
                                for a in (means, quats, scales, op))
    cam = lookat_camera(width=W, height=H, eye=(0, 0, -4))
    if surfels:
        proj = project_2dgs(jnp.asarray(means), jnp.asarray(quats),
                            jnp.asarray(scales), cam.viewmat, cam.K, W, H)
        radii = jb.cull_radius(proj.radii, jnp.asarray(op), guard_px=2.2)
        return (np.array(proj.means2d), np.array(radii),
                np.array(proj.depths), None, op)
    proj = project_3dgs(jnp.asarray(means), jnp.asarray(quats),
                        jnp.asarray(scales), cam.viewmat, cam.K, W, H)
    radii = jb.cull_radius(proj.radii, jnp.asarray(op))
    return (np.array(proj.means2d), np.array(radii), np.array(proj.depths),
            np.array(proj.conics), op)


def _both(cap):
    m2, r, d, con, op = _projected()
    ntx, nty = -(-W // TILE), -(-H // TILE)
    kw_j = dict(conics=jnp.asarray(con), opacities=jnp.asarray(op))
    t = [torch.from_numpy(a) for a in (m2, r, d, con, op)]
    ji = jb.build_tile_instances(jnp.asarray(m2), jnp.asarray(r),
                                 jnp.asarray(d), ntx, nty, TILE, TILE, cap,
                                 **kw_j)
    kw_t = dict(conics=t[3], opacities=t[4])
    ti = tb.build_tile_instances(*t[:3], ntx, nty, TILE, TILE, cap, **kw_t)
    jc = jb.count_tile_instances(jnp.asarray(m2), jnp.asarray(r), ntx, nty,
                                 TILE, TILE, **kw_j)
    tc = tb.count_tile_instances(t[0], t[1], ntx, nty, TILE, TILE, **kw_t)
    return ji, ti, int(jc), int(tc)


def test_cull_radius_matches():
    m2, r, d, con, op = _projected()
    radii = np.linspace(0, 20, op.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        tb.cull_radius(torch.from_numpy(radii), torch.from_numpy(op)).numpy(),
        np.asarray(jb.cull_radius(jnp.asarray(radii), jnp.asarray(op))),
        rtol=1e-6)


def test_segments_match():
    ji, ti, jc, tc = _both(cap=4096)
    assert tc == jc == int(ji.n_instances) == int(ti.n_instances)
    assert int(ti.n_dropped) == int(ji.n_dropped) == 0
    starts = np.asarray(ji.tile_starts)
    np.testing.assert_array_equal(ti.tile_starts.numpy(), starts)
    n_valid = starts[-1]
    np.testing.assert_array_equal(ti.gauss_id.numpy()[:n_valid],
                                  np.asarray(ji.gauss_id)[:n_valid])
    np.testing.assert_array_equal(ti.tile_id.numpy()[:n_valid],
                                  np.asarray(ji.tile_id)[:n_valid])
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))
    # ties are present: within a segment, runs of equal depth
    gid = ti.gauss_id.numpy()[:n_valid]
    assert (np.diff(gid) == 1).sum() > 0 and (gid < 200).sum() > 50


def test_overflow_counted():
    ji, ti, _, _ = _both(cap=256)
    assert int(ji.n_dropped) > 0
    assert int(ti.n_dropped) == int(ji.n_dropped)
    assert int(ti.n_instances) == int(ji.n_instances)
    starts = np.asarray(ji.tile_starts)
    np.testing.assert_array_equal(ti.tile_starts.numpy(), starts)
    np.testing.assert_array_equal(ti.gauss_id.numpy()[:starts[-1]],
                                  np.asarray(ji.gauss_id)[:starts[-1]])


def test_cull_radius_guard_matches():
    """The 2DGS guard (radii below 2.2 px never shrink) and the gradient:
    finite where op <= 1/255, where sqrt's derivative at 0 is infinite."""
    op = np.r_[np.linspace(1e-4, 0.99, 299), 1.0 / 255.0].astype(np.float32)
    radii = np.linspace(0, 6, op.shape[0]).astype(np.float32)
    got = tb.cull_radius(torch.from_numpy(radii), torch.from_numpy(op),
                         guard_px=2.2)
    want = jb.cull_radius(jnp.asarray(radii), jnp.asarray(op), guard_px=2.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    t_op = torch.from_numpy(op).requires_grad_(True)
    tb.cull_radius(torch.from_numpy(radii), t_op).sum().backward()
    assert torch.isfinite(t_op.grad).all()
    assert (t_op.grad[op <= 1.0 / 255.0] == 0).all()


@pytest.mark.parametrize("cap", [8192, 512], ids=["fits", "overflows"])
def test_circle_segments_match(cap):
    """The circle path (no conics) over 32x16 tiles: instance count, the
    enumerated capacity, tile starts and the sorted instance set."""
    m2, r, d, _, _ = _projected(surfels=True)
    tw, th = 32, 16
    ntx, nty = -(-W // tw), -(-H // th)
    ji = jb.build_tile_instances(jnp.asarray(m2), jnp.asarray(r),
                                 jnp.asarray(d), ntx, nty, tw, th, cap)
    t = [torch.from_numpy(a) for a in (m2, r, d)]
    ti = tb.build_tile_instances(*t, ntx, nty, tw, th, cap)
    jc = jb.count_tile_instances(jnp.asarray(m2), jnp.asarray(r), ntx, nty,
                                 tw, th)
    tc = tb.count_tile_instances(t[0], t[1], ntx, nty, tw, th)
    assert int(tc) == int(jc) == int(ji.n_instances) == int(ti.n_instances)
    assert int(ti.n_dropped) == int(ji.n_dropped)
    assert (int(ti.n_dropped) > 0) == (cap == 512)
    starts = np.asarray(ji.tile_starts)
    np.testing.assert_array_equal(ti.tile_starts.numpy(), starts)
    n_valid = starts[-1]
    np.testing.assert_array_equal(ti.gauss_id.numpy()[:n_valid],
                                  np.asarray(ji.gauss_id)[:n_valid])
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))
    # the rect-circle test pruned candidates the square spans enumerated
    assert n_valid < int(ji.n_instances) or cap == 512
