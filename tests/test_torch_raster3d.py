"""Port parity, K1 and K2: the plain versions against the JAX kernels
(Pallas in interpret mode) and against autograd, and the CUDA-path wrapper
against `rasterize_pallas_3dgs(interpret=True)`, forward and gradients.

Forward tolerances are those of `tests/test_raster_pallas.py`: renders
atol 1e-4 with rtol 2e-4 (the ED depth channel), alphas atol 2e-5; the
final transmittance compares as exp(logT) within 1e-4, since past the stop
the JAX kernel keeps adding the rest of its chunk pair to log T while the
port stops at the pixel. Gradients compare per field (or per input) within
2e-4 x that field's max |grad|: sums run in other orders, and through the
render the cotangent of log T is background x T_final, which differs
between the two packages below T = 1e-4 (the extra terms above): where
many pixels stop (the saturated stack) that path differs by more than the
tolerance, so that scene renders on a black background, as the JAX
package's own saturated-stack test does. The ED depth
channel D/alpha differentiates into two terms of size D/alpha^2 that cancel
where one gaussian dominates a pixel, which amplifies f32 summation-order
noise by 1/alpha: its cotangent is kept to pixels with alpha > 0.1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.data.synthetic import random_gaussians
from horizongs_tpu.ops import binning as jb
from horizongs_tpu.ops.pallas.raster3d import rasterize_fwd as j_fwd
from horizongs_tpu.ops.raster_pallas import _raster_core, rasterize_pallas_3dgs
from horizongs_tpu_torch.data.synthetic import lookat_camera as t_lookat
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops.raster_cuda import (
    _cull_radii,
    build_raster_inputs,
    rasterize_cuda_3dgs,
)

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

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
    acc, logT, n_contrib = raster3d.rasterize_fwd_plain(
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
    # n_contrib: the whole segment where the pixel never stopped, its own
    # stop (at most the segment) where it did; 0 on the empty tile
    counts = np.diff(starts)
    nc = n_contrib.numpy()
    assert (nc[0] == 0).all()
    stopped = logT[:, 0].numpy() <= raster3d.LOG_T_EPS
    np.testing.assert_array_equal(nc[~stopped],
                                  np.broadcast_to(counts[:, None],
                                                  nc.shape)[~stopped])
    assert (nc[4] < counts[4]).all() and (nc[4] >= 1).all()
    assert len(np.unique(nc[4])) > 3         # pixels stop one by one
    np.testing.assert_array_equal(i_fin, -(-nc.max(1) // G))


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
    # gradients now reach every differentiable input (K2 carries them)
    g, _, tc = _scene(n=8)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in g.items()}
    r, a, _ = rasterize_cuda_3dgs(t["means"], t["quats"], t["scales"],
                                  t["opacities"], t["colors"], tc.viewmat,
                                  tc.K, 64, 64, torch.full((3,), 0.3),
                                  render_mode="RGB+ED")
    (r.sum() + a.sum()).backward()
    for k, v in t.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k
    with torch.no_grad():                   # serving keeps no graph
        r, a, _ = rasterize_cuda_3dgs(t["means"], t["quats"], t["scales"],
                                      t["opacities"], t["colors"],
                                      tc.viewmat, tc.K, 64, 64,
                                      torch.full((3,), 0.3))
    assert r.grad_fn is None and a.grad_fn is None
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
    # K2's wrapper: wrong dtypes and shapes of the cotangents and records
    acc, logT, nc = raster3d.rasterize_fwd(*good, ntx, nty)
    bwd = (acc, logT[:, 0].contiguous(), logT[:, 0].contiguous(), nc)
    raster3d.rasterize_bwd(*good, *bwd, ntx, nty)          # accepted
    bad_bwd = [
        (acc.double(),) + bwd[1:],
        (acc[:, :4].contiguous(),) + bwd[1:],
        (acc, logT, bwd[2], nc),
        (acc, bwd[1], bwd[2][:-1].contiguous(), nc),
        bwd[:3] + (nc.long(),),
        bwd[:3] + (nc.float(),),
        (acc.transpose(1, 2).contiguous().transpose(1, 2),) + bwd[1:],
    ]
    for args in bad_bwd:
        with pytest.raises(ValueError):
            raster3d.rasterize_bwd(*good, *args, ntx, nty)
    with pytest.raises(ValueError):
        raster3d.rasterize_bwd(good[0][:, :9].contiguous(), *good[1:], *bwd,
                               ntx, nty)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _assert_grads_close(got, want, what, rel=2e-4):
    """Per column (field or input): within rel x that column's max |grad|."""
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    for col in range(want.shape[1]):
        scale = np.abs(want[:, col]).max()
        err = np.abs(got[:, col] - want[:, col]).max()
        assert err <= rel * scale, (what, col, err, scale)


def _cotangents(n_tiles, seed=5):
    rng = np.random.default_rng(seed)
    d_acc = rng.normal(size=(n_tiles, raster3d.N_ACC, raster3d.P))
    d_logT = rng.normal(size=(n_tiles, raster3d.P))
    return (torch.from_numpy(d_acc.astype(np.float32)),
            torch.from_numpy(d_logT.astype(np.float32)))


def _scene_inputs(g, w=64, h=64):
    """Binned fields of a seeded scene on the CPU: (fields, gauss_id,
    tile_starts, ntx, nty) and the projected arrays binning saw."""
    cam = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    ri = build_raster_inputs(t["means"], t["quats"], t["scales"],
                             t["opacities"], t["colors"], cam.viewmat,
                             cam.K, w, h)
    assert int(ri.inst.n_dropped) == 0
    proj = ri.proj
    binned = (proj.means2d, _cull_radii(proj, t["opacities"]), proj.depths,
              proj.conics, t["opacities"])
    return ((ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
             ri.grid.n_tiles_x, ri.grid.n_tiles_y),
            [x.numpy() for x in binned])


def _autograd_fields(args, d_acc, d_logT):
    fields = args[0].clone().requires_grad_(True)
    acc, logT, _ = raster3d.rasterize_fwd_plain(fields, *args[1:])
    (acc * d_acc).sum().backward(retain_graph=True)
    g = fields.grad.clone()
    fields.grad = None
    (logT[:, 0] * d_logT).sum().backward()
    return g + fields.grad


def _hand_made():
    f, gid, starts, ntx, nty = _instance_data()
    return (torch.from_numpy(f), torch.from_numpy(gid),
            torch.from_numpy(starts), ntx, nty)


def _seeded_scene():
    return _scene_inputs(random_gaussians(120, seed=4, extent=0.8,
                                          scale_range=(0.03, 0.15)))[0]


@pytest.mark.parametrize("inputs", [_hand_made, _seeded_scene],
                         ids=["hand_made_tiles", "seeded_scene"])
def test_plain_bwd_matches_autograd(inputs):
    args = inputs()
    n_tiles = args[3] * args[4]
    d_acc, d_logT = _cotangents(n_tiles)
    _, logT, nc = raster3d.rasterize_fwd_plain(*args)
    got = raster3d.rasterize_bwd(*args[:3], d_acc, d_logT,
                                 logT[:, 0].contiguous(), nc, *args[3:])
    want = _autograd_fields(args, d_acc, d_logT)
    _assert_grads_close(got.numpy(), want.numpy(), "fields")
    assert np.abs(want.numpy()).max(0).min() > 0     # every field is hit


def test_plain_bwd_walks_from_each_pixels_stop():
    """A reverse walk that starts every pixel of a tile at the tile's
    walked chunks (i_fin) rebuilds the T of a pixel that stopped early past
    its stop, and its gradients are wrong: the per-pixel n_contrib is what
    makes them right."""
    args = _hand_made()
    d_acc, d_logT = _cotangents(args[3] * args[4])
    _, logT, nc = raster3d.rasterize_fwd_plain(*args)
    counts = torch.diff(args[2])
    i_fin = logT[:, 1, 0].long()
    tile_wide = torch.minimum(i_fin * G, counts)[:, None].expand_as(nc)
    assert (tile_wide != nc).any()
    want = _autograd_fields(args, d_acc, d_logT).numpy()
    bad = raster3d.rasterize_bwd(*args[:3], d_acc, d_logT,
                                 logT[:, 0].contiguous(),
                                 tile_wide.int().contiguous(), *args[3:])
    with pytest.raises(AssertionError):
        _assert_grads_close(bad.numpy(), want, "fields")


def test_n_contrib_off_the_stop():
    """The tolerance K1's n_contrib is held to: a count one gaussian later
    at a pixel that stopped passes; a changed count at a pixel that never
    stopped, or one that skips two contributing gaussians, does not."""
    args = _hand_made()
    fields, gid, starts, ntx = args[:4]
    _, logT, nc = raster3d.rasterize_fwd_plain(*args)
    lt = logT[:, 0]

    def off(nc_b):
        return raster3d.n_contrib_off_the_stop(fields, gid, starts, ntx, nc,
                                               lt, nc_b, lt)

    assert off(nc.clone()) == 0
    # a pixel of the saturated tile 4 that stopped with two gaussians of
    # alpha > 0 still ahead of it
    t = 4
    lx, ly = raster3d.local_pixel_coords("cpu")
    alpha = raster3d.segment_alpha(
        fields[gid[int(starts[t]):int(starts[t + 1])].long()], t, ntx, lx, ly)
    past = torch.arange(alpha.shape[1])[None, :] >= nc[t][:, None]
    ahead = torch.cumsum(((alpha > 0) & past).int(), 1)
    p = int(((lt[t] <= raster3d.LOG_T_EPS) & (ahead[:, -1] >= 2))
            .nonzero()[0])
    later = nc.clone()
    later[t, p] += 1
    assert off(later) == 0
    # the fewest gaussians past the stop that hold two with alpha > 0
    k = int((ahead[p] == 2).nonzero()[0]) + 1 - int(nc[t, p])
    skipped = nc.clone()
    skipped[t, p] += k
    assert off(skipped) == 1
    t2, p2 = (lt > raster3d.LOG_T_EPS).nonzero()[0].tolist()
    short = nc.clone()
    short[t2, p2] -= 1
    assert off(short) == 1


def test_bwd_unwalked_gaussians_get_exact_zeros():
    args = _hand_made()
    fields, gid, starts = args[:3]
    d_acc, d_logT = _cotangents(args[3] * args[4])
    _, logT, nc = raster3d.rasterize_fwd_plain(*args)
    grad = raster3d.rasterize_bwd(*args[:3], d_acc, d_logT,
                                  logT[:, 0].contiguous(), nc, *args[3:])
    # walked: inside some pixel's n_contrib; hit: walked with alpha > 0
    walked = torch.zeros(fields.shape[0], dtype=torch.bool)
    hit = torch.zeros(fields.shape[0], dtype=torch.bool)
    lx, ly = raster3d.local_pixel_coords("cpu")
    s = starts.tolist()
    for t in range(len(s) - 1):
        ids = gid[s[t]:s[t + 1]].long()
        alpha = raster3d.segment_alpha(fields[ids], t, args[3], lx, ly)
        in_walk = torch.arange(len(ids))[None, :] < nc[t][:, None]
        walked[ids[in_walk.any(0)]] = True
        hit[ids[(in_walk & (alpha > 0)).any(0)]] = True
    assert (~walked).sum() > 20                 # never binned, or occluded
    assert (grad[~walked] == 0).all()
    assert (grad[hit].abs().sum(1) > 0).all()


def test_bwd_matches_jax_vjp():
    """The port's field gradients against `jax.vjp` of the JAX package's
    `_raster_core` (Pallas fwd/bwd in interpret mode, with its routing),
    on the TileInstances the JAX binning builds for the same scene."""
    g = random_gaussians(160, seed=9, extent=0.8, scale_range=(0.03, 0.15))
    g["opacities"][:40] = 0.97
    args, binned = _scene_inputs(g)
    fields, gid, starts, ntx, nty = args
    m2, radii, depths, conics, op = (jnp.asarray(a) for a in binned)
    cap = -(-gid.shape[0] // G) * G
    inst = jb.build_tile_instances(m2, radii, depths, ntx, nty, 32, 32, cap,
                                   conics=conics, opacities=op)
    np.testing.assert_array_equal(np.asarray(inst.tile_starts),
                                  starts.numpy())
    n_tiles = ntx * nty
    d_acc, d_logT = _cotangents(n_tiles, seed=6)
    j_dacc = np.zeros((n_tiles, 16, raster3d.P), np.float32)
    j_dacc[:, 6:11] = d_acc.numpy()
    j_dlogT = np.zeros((n_tiles, 2, raster3d.P), np.float32)
    j_dlogT[:, 0] = d_logT.numpy()
    _, vjp = jax.vjp(lambda f: _raster_core(f, inst, ntx, nty, True),
                     jnp.asarray(fields.numpy()))
    (want,) = vjp((jnp.asarray(j_dacc), jnp.asarray(j_dlogT)))
    _, logT, nc = raster3d.rasterize_fwd(*args)
    assert (logT[:, 0] <= raster3d.LOG_T_EPS).any()     # some pixels stop
    got = raster3d.rasterize_bwd(fields, gid, starts, d_acc, d_logT,
                                 logT[:, 0].contiguous(), nc, ntx, nty)
    _assert_grads_close(got.numpy(), np.asarray(want), "fields")


def _grad_compare(g, w, h, mode, bg=(0.2, 0.3, 0.4)):
    keys = ("means", "quats", "scales", "opacities", "colors")
    bg = np.array(bg, np.float32)
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    rng = np.random.default_rng(8)
    n_ch = 3 if mode == "RGB" else 4
    R1 = rng.normal(size=(h, w, n_ch)).astype(np.float32)
    R2 = rng.normal(size=(h, w, 1)).astype(np.float32)
    diff = (0, 2, 3, 4)          # means, scales, opacities, colors
    if mode == "RGB+ED":
        _, a_j, _ = rasterize_pallas_3dgs(
            *(jnp.asarray(g[k]) for k in keys), jc.viewmat, jc.K, w, h,
            jnp.asarray(bg), render_mode=mode, interpret=True)
        R1[..., 3:] *= np.asarray(a_j) > 0.1

    def j_loss(means, scales, op, col):
        r, a, _ = rasterize_pallas_3dgs(
            means, jnp.asarray(g["quats"]), scales, op, col, jc.viewmat,
            jc.K, w, h, jnp.asarray(bg), render_mode=mode, interpret=True)
        return jnp.sum(r * R1) + jnp.sum(a * R2)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(g[keys[i]]) for i in diff))
    t = {k: torch.from_numpy(g[k]).requires_grad_(True) for k in keys}
    r, a, _ = rasterize_cuda_3dgs(*(t[k] for k in keys), tc.viewmat, tc.K,
                                  w, h, torch.from_numpy(bg),
                                  render_mode=mode)
    ((r * torch.from_numpy(R1)).sum()
     + (a * torch.from_numpy(R2)).sum()).backward()
    for i, wj in zip(diff, want):
        _assert_grads_close(t[keys[i]].grad.numpy(), np.asarray(wj),
                            keys[i])


@pytest.mark.parametrize("mode", ["RGB", "RGB+D", "RGB+ED"])
def test_wrapper_grads_match_pallas(mode):
    g, _, _ = _scene()
    _grad_compare(g, 64, 64, mode)


def test_wrapper_grads_match_pallas_saturated_stack():
    _grad_compare(_stack(), 64, 64, "RGB", bg=(0.0, 0.0, 0.0))

