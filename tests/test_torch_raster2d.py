"""Port parity, K3 and K4: the plain versions against the JAX 2DGS kernels
(Pallas in interpret mode), the dense oracle and autograd; the CUDA-path
wrapper against `rasterize_pallas_2dgs(interpret=True)` and the dense
oracle, forward and gradients; `render_dense_2dgs` and `depth_to_normals`
against the JAX package's.

Tolerances are those of `tests/test_raster2d_pallas.py`: alphas atol 2e-5,
renders and normals 2e-4, distortion 5e-4, median depth 1e-4, normals from
depth 5e-4; gradients per field (or input) within 2e-4 x its max |grad|.
Between the two packages the depth-valued outputs (the ED channel, D, the
median) also get rtol 2e-4, as the 3DGS port tests do: the projections
differ by ulps (XLA fuses some products into FMAs) and a surfel seen nearly
edge-on has a far hit depth (z near 60 here) that amplifies them. Where a
pixel stops (T <= 1e-4) the JAX kernel keeps adding log1p(-alpha) to its
log T, so final transmittances compare as exp(log T) within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.data.synthetic import lookat_camera as j_lookat
from horizongs_tpu.data.synthetic import random_gaussians
from horizongs_tpu.ops import binning as jb
from horizongs_tpu.ops import reference as jref
from horizongs_tpu.ops.pallas.raster2d import rasterize2d_fwd as j_fwd2d
from horizongs_tpu.ops.raster_pallas import (
    _raster2d_core,
    rasterize_pallas_2dgs,
)
from horizongs_tpu_torch.data.synthetic import lookat_camera as t_lookat
from horizongs_tpu_torch.ops import raster2d
from horizongs_tpu_torch.ops.raster_cuda import (
    GUARD_PX_2DGS,
    _cull_radii,
    build_raster_inputs_2dgs,
    rasterize_cuda_2dgs,
)
from horizongs_tpu_torch.ops.reference import depth_to_normals
from horizongs_tpu_torch.ops.reference import render_dense_2dgs as t_dense2d

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

KEYS = ("means", "quats", "scales", "opacities", "colors")
OUT_NAMES = ("render", "alphas", "normals", "normals_from_depth", "distort",
             "median")
# atol and rtol of each 2DGS output, in the order of OUT_NAMES
TOLS = ((2e-4, 2e-4), (2e-5, 0.0), (2e-4, 0.0), (5e-4, 0.0), (5e-4, 0.0),
        (1e-4, 2e-4))


def jax_depth_to_normals_safe(depth, K, row0=0.0):
    """The JAX package's `depth_to_normals` with the port's gradient-safe
    norm: the same values, and a zero gradient where the normal is zero
    (the JAX function's gradient is NaN there: sqrt'(0) = inf)."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xs = jnp.arange(W, dtype=depth.dtype) + 0.5
    ys = jnp.arange(H, dtype=depth.dtype) + 0.5 + row0
    px = (xs[None, :] - cx) / fx
    py = (ys[:, None] - cy) / fy
    pts = jnp.stack([px * depth, py * depth, depth], axis=-1)
    ddx = jnp.zeros_like(pts).at[:, 1:-1].set((pts[:, 2:] - pts[:, :-2]) * 0.5)
    ddy = jnp.zeros_like(pts).at[1:-1, :].set((pts[2:, :] - pts[:-2, :]) * 0.5)
    n = jnp.cross(ddx, ddy)
    sq = jnp.sum(n * n, axis=-1, keepdims=True)
    ok = sq > 1e-16
    n = jnp.where(ok, n / jnp.sqrt(jnp.where(ok, sq, 1.0)), 0.0)
    return jnp.where((depth > 0)[..., None], n, 0.0)


@pytest.fixture
def safe_depth_normals(monkeypatch):
    monkeypatch.setattr(jref, "depth_to_normals", jax_depth_to_normals_safe)


def _cloud(n=96, seed=3):
    return random_gaussians(n, seed=seed, extent=0.8,
                            scale_range=(0.03, 0.12))


def _stack(n=400, seed=7):
    """Large surfels tilted a little from facing the camera, stacked in
    depth over the whole 64x64 view (almost every pixel stops before its
    segment ends), and 60 small ones behind their middle, which no pixel
    reaches."""
    rng = np.random.default_rng(seed)
    m = 60
    means = np.concatenate([
        np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                  np.linspace(-0.5, 0.5, n)], axis=1),
        np.stack([rng.uniform(-0.05, 0.05, m), rng.uniform(-0.05, 0.05, m),
                  np.full(m, 1.0)], axis=1)])
    quats = np.concatenate([np.ones((n + m, 1)),
                            rng.normal(scale=0.2, size=(n + m, 3))], axis=1)
    scales = np.r_[np.full(n, 0.8), np.full(m, 0.05)][:, None].repeat(3, 1)
    return {"means": means.astype(np.float32),
            "quats": quats.astype(np.float32),
            "scales": scales.astype(np.float32),
            "opacities": np.full((n + m,), 0.95, np.float32),
            "colors": rng.uniform(0, 1, (n + m, 3)).astype(np.float32)}


def _inputs(g, w=64, h=64, cap=16384):
    """The K3 launch's inputs for a seeded scene on the CPU: (fields,
    gauss_id, tile_starts, n_tiles_x, n_tiles_y), and the binning's
    projected arrays as numpy."""
    cam = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    ri = build_raster_inputs_2dgs(*(t[k] for k in KEYS), cam.viewmat, cam.K,
                                  w, h, cap=cap)
    assert int(ri.inst.n_dropped) == 0
    binned = (ri.proj.means2d, _cull_radii(ri.proj, t["opacities"],
                                           GUARD_PX_2DGS), ri.proj.depths)
    return ((ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
             ri.grid.n_tiles_x, ri.grid.n_tiles_y),
            [x.numpy() for x in binned])


def _jax_inst(fields, gauss_id):
    """The JAX kernel's (24, CAP+2G) transposed instance buffer: the 18
    field rows, row 18 the validity flag."""
    G = raster2d.G
    n = gauss_id.shape[0]
    cap = -(-n // G) * G
    inst = np.zeros((24, cap + 2 * G), np.float32)
    inst[:18, :n] = fields.numpy()[gauss_id.numpy()].T
    inst[18, :n] = 1.0
    return inst


SCENES = {"cloud": (_cloud, 64, 64), "stack": (_stack, 64, 64),
          "ragged_50x38": (lambda: _cloud(64), 50, 38)}


@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_fwd_matches_jax_kernel(scene):
    make, w, h = SCENES[scene]
    args, _ = _inputs(make(), w, h)
    acc, aux, rec = raster2d.rasterize2d_fwd_plain(*args)
    j_acc, j_aux = j_fwd2d(jnp.asarray(_jax_inst(args[0], args[1])),
                           jnp.asarray(args[2].numpy()), args[3], args[4],
                           interpret=True)
    j_acc, j_aux = np.asarray(j_acc), np.asarray(j_aux)
    np.testing.assert_allclose(acc[:, 0:6].numpy(), j_acc[:, 12:18],
                               atol=1e-4)
    np.testing.assert_allclose(acc[:, 6].numpy(), j_acc[:, 18], atol=2e-5)
    np.testing.assert_allclose(acc[:, 6].numpy(), j_aux[:, 5], atol=2e-5)
    np.testing.assert_allclose(np.exp(aux[:, 0].numpy()),
                               np.exp(j_aux[:, 0]), atol=1e-4)
    np.testing.assert_allclose(aux[:, 1].numpy(), j_aux[:, 1], atol=1e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(aux[:, 2].numpy(), j_aux[:, 2], atol=5e-4)
    np.testing.assert_allclose(aux[:, 3].numpy(), j_aux[:, 3], atol=1e-4,
                               rtol=2e-4)
    # the median's position in the segment (the TPU kernel's float column)
    np.testing.assert_array_equal(rec[:, 1].numpy(), j_aux[:, 4])
    stopped = aux[:, 0] <= raster2d.LOG_T_EPS
    counts = torch.diff(args[2])[:, None].expand_as(rec[:, 0])
    assert (rec[:, 0][~stopped] == counts[~stopped]).all()
    assert (rec[:, 0][stopped] < counts[stopped]).all()
    if scene == "stack":
        assert stopped.sum() > 3000 and (rec[:, 1] >= 0).all()
    else:
        assert (rec[:, 1] < 0).any() and (acc[:, 6] == 0).any()


def _outputs(out):
    return [np.asarray(x) if not torch.is_tensor(x) else x.detach().numpy()
            for x in out[:6]]


def _assert_outputs_close(got, want, what):
    for name, a, b, (atol, rtol) in zip(OUT_NAMES, got, want, TOLS):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("mode, size", [("RGB", (64, 64)),
                                        ("RGB+ED", (64, 64)),
                                        ("RGB", (50, 38))],
                         ids=["rgb", "rgb_ed", "ragged_50x38"])
def test_wrapper_matches_pallas_and_dense(mode, size):
    """The port's cuda path (plain K3 on the CPU) against the JAX package's
    Pallas path and its dense oracle: all six maps and the info."""
    w, h = size
    g = _cloud(96 if w == 64 else 64)
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    j_args = (*(jnp.asarray(g[k]) for k in KEYS), jc.viewmat, jc.K, w, h,
              jnp.asarray(bg))
    jp = rasterize_pallas_2dgs(*j_args, render_mode=mode, interpret=True)
    jd = jref.render_dense_2dgs(*j_args, render_mode=mode)
    tp = rasterize_cuda_2dgs(*(torch.from_numpy(g[k]) for k in KEYS),
                             tc.viewmat, tc.K, w, h, torch.from_numpy(bg),
                             render_mode=mode)
    assert tp[0].shape == jp[0].shape == (h, w, 3 if mode == "RGB" else 4)
    assert set(tp[-1]) == set(jp[-1])
    for k in ("n_instances", "n_dropped"):
        assert int(tp[-1][k]) == int(jp[-1][k])
    np.testing.assert_array_equal(tp[-1]["radii"].numpy(),
                                  np.asarray(jp[-1]["radii"]))
    _assert_outputs_close(_outputs(tp), _outputs(jp), "pallas")
    _assert_outputs_close(_outputs(tp), _outputs(jd), "dense")
    assert float(tp[1].max()) > 0.5 and float(tp[5].max()) > 0


def test_render_dense_2dgs_matches_jax():
    w = h = 64
    g = _cloud()
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    jd = jref.render_dense_2dgs(*(jnp.asarray(g[k]) for k in KEYS),
                                jc.viewmat, jc.K, w, h, jnp.asarray(bg),
                                render_mode="RGB+ED")
    td = t_dense2d(*(torch.from_numpy(g[k]) for k in KEYS), tc.viewmat,
                   tc.K, w, h, torch.from_numpy(bg), render_mode="RGB+ED")
    _assert_outputs_close(_outputs(td), _outputs(jd), "dense")
    np.testing.assert_array_equal(td[-1]["radii"].numpy(),
                                  np.asarray(jd[-1]["radii"]))


def test_depth_to_normals_matches_jax():
    """Values equal the JAX function's; the gradient is finite everywhere
    and equals the JAX one's wherever that is finite (it is NaN on the
    border, where the normal is zero)."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(2.0, 3.0, (20, 24)).astype(np.float32)
    depth[5:9, 6:12] = 0.0                          # no depth there
    K = np.array([[40.0, 0, 12.0], [0, 40.0, 10.0], [0, 0, 1]], np.float32)
    cot = rng.normal(size=(20, 24, 3)).astype(np.float32)
    jv, jvjp = jax.vjp(lambda d: jref.depth_to_normals(d, jnp.asarray(K)),
                       jnp.asarray(depth))
    tdep = torch.from_numpy(depth).requires_grad_(True)
    tv = depth_to_normals(tdep, torch.from_numpy(K))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-6)
    (tv * torch.from_numpy(cot)).sum().backward()
    jg = np.asarray(jvjp(jnp.asarray(cot))[0])
    tg = tdep.grad.numpy()
    assert np.isfinite(tg).all() and not np.isfinite(jg).all()
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg[fin], jg[fin], atol=1e-5 * np.abs(jg[fin])
                               .max())
    safe = jax.vjp(lambda d: jax_depth_to_normals_safe(d, jnp.asarray(K)),
                   jnp.asarray(depth))[1](jnp.asarray(cot))[0]
    np.testing.assert_allclose(tg, np.asarray(safe),
                               atol=1e-5 * np.abs(tg).max())


# ---------------------------------------------------------------------------
# K4
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
    d_acc = rng.normal(size=(n_tiles, raster2d.N_ACC, raster2d.P))
    d_aux = rng.normal(size=(n_tiles, raster2d.N_AUX, raster2d.P))
    return (torch.from_numpy(d_acc.astype(np.float32)),
            torch.from_numpy(d_aux.astype(np.float32)))


def _autograd_fields(args, d_acc, d_aux):
    fields = args[0].clone().requires_grad_(True)
    acc, aux, _ = raster2d.rasterize2d_fwd_plain(fields, *args[1:])
    ((acc * d_acc).sum() + (aux * d_aux).sum()).backward()
    return fields.grad


@pytest.mark.parametrize("scene", ["cloud", "stack"])
def test_plain_bwd_matches_autograd(scene):
    """Every cotangent (acc rows, log T, D, distortion, median) at once."""
    make, w, h = SCENES[scene]
    args, _ = _inputs(make(), w, h)
    d_acc, d_aux = _cotangents(args[3] * args[4])
    acc, aux, rec = raster2d.rasterize2d_fwd_plain(*args)
    got = raster2d.rasterize2d_bwd(*args[:3], d_acc, d_aux, acc, aux, rec,
                                   *args[3:])
    want = _autograd_fields(args, d_acc, d_aux)
    _assert_grads_close(got.numpy(), want.numpy(), "fields")
    assert np.abs(want.numpy()).max(0).min() > 0     # every field is hit


def test_plain_bwd_walks_from_each_pixels_stop():
    """A reverse walk that starts every pixel of a tile at the tile's
    furthest walk rebuilds the T of a pixel that stopped early past its
    stop, and its gradients are wrong: the per-pixel n_contrib is what
    makes them right."""
    make, w, h = SCENES["stack"]
    args, _ = _inputs(make(), w, h)
    d_acc, d_aux = _cotangents(args[3] * args[4])
    acc, aux, rec = raster2d.rasterize2d_fwd_plain(*args)
    tile_wide = rec.clone()
    tile_wide[:, 0] = rec[:, 0].amax(dim=1, keepdim=True)
    assert (tile_wide != rec).any()
    want = _autograd_fields(args, d_acc, d_aux).numpy()
    bad = raster2d.rasterize2d_bwd(*args[:3], d_acc, d_aux, acc, aux,
                                   tile_wide, *args[3:])
    with pytest.raises(AssertionError):
        _assert_grads_close(bad.numpy(), want, "fields")


def test_bwd_unwalked_surfels_get_exact_zeros():
    make, w, h = SCENES["stack"]
    args, _ = _inputs(make(), w, h)
    fields, gid, starts = args[:3]
    d_acc, d_aux = _cotangents(args[3] * args[4])
    acc, aux, rec = raster2d.rasterize2d_fwd_plain(*args)
    grad = raster2d.rasterize2d_bwd(*args[:3], d_acc, d_aux, acc, aux, rec,
                                    *args[3:])
    walked = torch.zeros(fields.shape[0], dtype=torch.bool)
    hit = torch.zeros(fields.shape[0], dtype=torch.bool)
    lx, ly = raster2d.local_pixel_coords("cpu")
    s = starts.tolist()
    for t in range(len(s) - 1):
        ids = gid[s[t]:s[t + 1]].long()
        alpha = raster2d.segment_geometry(fields[ids], t, args[3], lx,
                                          ly)["alpha"]
        in_walk = torch.arange(len(ids))[None, :] < rec[t, 0][:, None]
        walked[ids[in_walk.any(0)]] = True
        hit[ids[(in_walk & (alpha > 0)).any(0)]] = True
    assert (~walked).sum() == 60                # hidden behind the stack
    assert (grad[~walked] == 0).all()
    assert (grad[hit].abs().sum(1) > 0).all()


def test_records_off_the_boundary():
    """The tolerance K3's records are held to: n_contrib one gaussian later
    at a stopped pixel passes; a median moved where log T is not near
    log 0.5, or a pixel that never stopped with a shorter walk, do not."""
    make, w, h = SCENES["stack"]
    args, _ = _inputs(make(), w, h)
    acc, aux, rec = raster2d.rasterize2d_fwd_plain(*args)
    lt = aux[:, 0]

    def off(rec_b):
        return raster2d.records_off_the_boundary(*args[:4], rec, lt, rec_b,
                                                 lt)

    assert off(rec.clone()) == (0, 0)
    # a stopped pixel with two contributing surfels still ahead of it
    t = int((lt <= raster2d.LOG_T_EPS).sum(1).argmax())
    s, e = int(args[2][t]), int(args[2][t + 1])
    alpha = raster2d.segment_geometry(
        args[0][args[1][s:e].long()], t, args[3],
        *raster2d.local_pixel_coords("cpu"))["alpha"]
    past = torch.arange(e - s)[None, :] >= rec[t, 0][:, None]
    ahead = torch.cumsum(((alpha > 0) & past).int(), 1)
    p = int(((lt[t] <= raster2d.LOG_T_EPS) & (ahead[:, -1] >= 2))
            .nonzero()[0])
    later = rec.clone()
    later[t, 0, p] += 1
    assert off(later) == (0, 0)
    skipped = rec.clone()
    skipped[t, 0, p] = int((ahead[p] == 2).nonzero()[0]) + 1
    assert off(skipped) == (1, 0)
    moved = rec.clone()
    t, p = (rec[:, 1] >= 0).nonzero()[0].tolist()
    moved[t, 1, p] += 1
    assert off(moved) == (0, 1)
    t, p = (lt > raster2d.LOG_T_EPS).nonzero()[0].tolist()
    short = rec.clone()
    short[t, 0, p] -= 1
    assert off(short) == (1, 0)


def test_bwd_matches_jax_vjp():
    """The port's field gradients against `jax.vjp` of the JAX package's
    `_raster2d_core` (Pallas fwd/bwd in interpret mode, with its routing),
    on the TileInstances the JAX binning builds for the same scene, with
    cotangents on every acc and aux output. No pixel stops in this scene:
    the JAX kernel restarts every pixel at its tile's i_fin."""
    args, binned = _inputs(_cloud(80, seed=4))
    fields, gid, starts, ntx, nty = args
    m2, radii, depths = (jnp.asarray(a) for a in binned)
    cap = -(-gid.shape[0] // raster2d.G) * raster2d.G
    inst = jb.build_tile_instances(m2, radii, depths, ntx, nty,
                                   raster2d.TILE_W, raster2d.TILE_H, cap)
    np.testing.assert_array_equal(np.asarray(inst.tile_starts),
                                  starts.numpy())
    n_tiles = ntx * nty
    d_acc, d_aux = _cotangents(n_tiles, seed=6)
    j_dacc = np.zeros((n_tiles, 24, raster2d.P), np.float32)
    j_dacc[:, 12:19] = d_acc.numpy()
    j_daux = np.zeros((n_tiles, 8, raster2d.P), np.float32)
    j_daux[:, 0:4] = d_aux.numpy()
    _, vjp = jax.vjp(lambda f: _raster2d_core(f, inst, ntx, nty, True),
                     jnp.asarray(fields.numpy()))
    (want,) = vjp((jnp.asarray(j_dacc), jnp.asarray(j_daux)))
    acc, aux, rec = raster2d.rasterize2d_fwd(*args)
    assert not (aux[:, 0] <= raster2d.LOG_T_EPS).any()
    assert (rec[:, 1] >= 0).sum() > 100                # medians are hit
    got = raster2d.rasterize2d_bwd(fields, gid, starts, d_acc, d_aux, acc,
                                   aux, rec, ntx, nty)
    _assert_grads_close(got.numpy(), np.asarray(want), "fields")


def test_wrapper_grads_match_dense_oracle():
    """`test_raster2d_pallas.test_pallas2d_gradients_match_dense` in the
    port: every differentiable output in the loss, gradients against
    `jax.grad` of the JAX dense oracle, per input column within 2e-4 x its
    max |grad|."""
    w = h = 64
    g = _cloud(48)
    jc = j_lookat(width=w, height=h, eye=(0, 0, -4))
    tc = t_lookat(width=w, height=h, eye=(0, 0, -4), device="cpu")

    def loss(out, mean):
        r, a, n, _, dist, med = out[:6]
        return (mean((r - 0.5) ** 2) + 0.1 * mean(a) + 0.05 * mean(n)
                + 0.02 * mean(dist) + 0.03 * mean(med))

    def j_loss(*xs):
        return loss(jref.render_dense_2dgs(*xs, jc.viewmat, jc.K, w, h,
                                           jnp.zeros(3),
                                           render_mode="RGB+ED"), jnp.mean)

    want = jax.grad(j_loss, argnums=tuple(range(5)))(
        *(jnp.asarray(g[k]) for k in KEYS))
    ts = [torch.from_numpy(g[k]).requires_grad_(True) for k in KEYS]
    loss(rasterize_cuda_2dgs(*ts, tc.viewmat, tc.K, w, h, torch.zeros(3),
                             render_mode="RGB+ED"), torch.mean).backward()
    for name, t, wj in zip(KEYS, ts, want):
        _assert_grads_close(t.grad.numpy(), np.asarray(wj), name)


def test_wrapper_checks_inputs():
    """Gradients reach every differentiable input; serving keeps no graph;
    K3's and K4's wrappers refuse wrong dtypes, shapes and layouts."""
    g = _cloud(24)
    tc = t_lookat(width=64, height=64, eye=(0, 0, -4), device="cpu")
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in g.items()}
    out = rasterize_cuda_2dgs(*(t[k] for k in KEYS), tc.viewmat, tc.K, 64,
                              64, torch.full((3,), 0.3),
                              render_mode="RGB+ED")
    sum(x.sum() for x in out[:6]).backward()
    for k, v in t.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k
    with torch.no_grad():
        out = rasterize_cuda_2dgs(*(t[k] for k in KEYS), tc.viewmat, tc.K,
                                  64, 64, torch.full((3,), 0.3))
    assert all(x.grad_fn is None for x in out[:6])
    args, _ = _inputs(g)
    f, gid, starts, ntx, nty = args
    for bad in ((f.double(), gid, starts), (f, gid.long(), starts),
                (f[:, :17].contiguous(), gid, starts),
                (f.T.contiguous().T, gid, starts), (f, gid, starts[:-1])):
        with pytest.raises(ValueError):
            raster2d.rasterize2d_fwd(*bad, ntx, nty)
    acc, aux, rec = raster2d.rasterize2d_fwd(*args)
    good = (acc, aux, acc, aux, rec)
    raster2d.rasterize2d_bwd(f, gid, starts, *good, ntx, nty)    # accepted
    for i, bad in ((0, acc.double()), (1, aux[:, :3].contiguous()),
                   (2, acc.transpose(1, 2).contiguous().transpose(1, 2)),
                   (4, rec.float()), (4, rec[:, :1].contiguous())):
        b = list(good)
        b[i] = bad
        with pytest.raises(ValueError):
            raster2d.rasterize2d_bwd(f, gid, starts, *b, ntx, nty)
