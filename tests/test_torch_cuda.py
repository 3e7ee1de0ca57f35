"""K1-K4 on the card: the CUDA kernels against their plain versions, the
cuda render path against the dense oracle, and one training step of the
flagship configuration, 3DGS and 2DGS, on the card against the same step
on the CPU. Skipped without a CUDA device.
The file imports no JAX, so on a GPU machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.data.synthetic import lookat_camera, random_gaussians
from horizongs_tpu_torch.ops import raster2d, raster3d
from horizongs_tpu_torch.ops.raster_cuda import (
    build_raster_inputs,
    build_raster_inputs_2dgs,
)
from horizongs_tpu_torch.render import render


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from horizongs_tpu_torch.device import disable_tf32
    disable_tf32()
    return torch.device("cuda")


def _scene(dev, n=2000, seed=3):
    g = random_gaussians(n, seed=seed, extent=0.8, scale_range=(0.02, 0.12))
    g["opacities"][: n // 4] = 0.97          # an opaque front: early stops
    return {k: torch.from_numpy(v).to(dev) for k, v in g.items()}


C255 = np.float32(1.0 / 255.0)
ULP = np.float32(2.0 ** -23)


def _fields3d(mx, my, a, b, c, op, rng):
    """(N, 10) float32 fields [mx, my, a, b, c, op, r, g, b, depth]."""
    n = len(mx)
    return torch.from_numpy(np.stack(
        [mx, my, a, b, c, op, *rng.uniform(0, 1, (3, n)),
         rng.uniform(1, 5, n)], axis=1).astype(np.float32))


def _conics(rng, n, log_scale=(-3.0, 0.0), log_kappa=(0.0, 7.0)):
    """n conics (a, b, c) of random orientation, the larger eigenvalue
    10^U(log_scale), the condition number 10^U(log_kappa)."""
    lam1 = 10.0 ** rng.uniform(*log_scale, n)
    lam2 = lam1 / 10.0 ** rng.uniform(*log_kappa, n)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    return (lam1 * cs * cs + lam2 * sn * sn, (lam1 - lam2) * sn * cs,
            lam1 * sn * sn + lam2 * cs * cs)


def _sigma_at(f, x, y):
    """float32 sigma of each gaussian of f at pixel centre (x, y), in the
    kernels' order."""
    dx = torch.tensor(np.float32(x)) - f[:, 0]
    dy = torch.tensor(np.float32(y)) - f[:, 1]
    return (0.5 * f[:, 2] * dx * dx + f[:, 3] * dx * dy
            + 0.5 * f[:, 4] * dy * dy)


def _random_gaussians3d(seed=31, n=300):
    """Positive-definite conics of every conditioning (up to 1e7), means on
    and around a 64x64 grid, opacities from 1/255 to 1."""
    rng = np.random.default_rng(seed)
    a, b, c = _conics(rng, n)
    return _fields3d(rng.uniform(-12, 76, n), rng.uniform(-12, 76, n), a, b,
                     c, rng.uniform(C255, 1.0, n), rng)


def _opacity_gaussians3d(seed=32, n=300):
    """Opacities at the edges of the cut-off: 1/255 and a few ulps either
    side, near 1, zero and negative, and set so that one pixel's
    op·exp(-sigma) lands within an ulp or two of 1/255."""
    rng = np.random.default_rng(seed)
    a, b, c = _conics(rng, n, log_scale=(-2.0, 0.0), log_kappa=(0.0, 3.0))
    mx, my = rng.uniform(0, 64, n), rng.uniform(0, 64, n)
    f = _fields3d(mx, my, a, b, c, np.ones(n), rng)
    px = np.floor(mx + rng.uniform(-6, 6, n)) + 0.5
    py = np.floor(my + rng.uniform(-6, 6, n)) + 0.5
    sig = np.array([float(_sigma_at(f[j:j + 1], px[j], py[j])[0])
                    for j in range(n)])
    choices = [C255 * (1 + k * ULP) for k in (-1, 0, 1, 2, 8)] + \
        [np.float32(0.9999), np.float32(1.0), np.float32(0.0),
         np.float32(-0.5)]
    op = np.empty(n, np.float32)
    for j in range(n):
        if j % 2 and sig[j] < 5.5:           # the cut-off at one pixel
            op[j] = np.float32(C255 * np.exp(sig[j])) \
                * (1 + ULP * ((j // 2) % 5 - 2))
        else:
            op[j] = choices[j % len(choices)]
    f[:, 5] = torch.from_numpy(op)
    return f


def _degenerate_gaussians3d(seed=33, n=300):
    """Finite conics at the edges, in this order: det -> 0 (b^2 = ac (1 -
    1e-8..1e-2)), huge (1e3..1e8) and tiny (1e-38..1e-6, subnormal
    included) a and c, a <= 0, and last the indefinite ones (b^2 > ac),
    which saturate most pixels they reach; opacities in (0.05, 1]."""
    rng = np.random.default_rng(seed)
    k = n // 5
    a = 10.0 ** rng.uniform(-3, 0, n)
    c = 10.0 ** rng.uniform(-3, 0, n)
    sgn = rng.choice([-1.0, 1.0], n)
    b = sgn * np.sqrt(a * c * (1 - 10.0 ** rng.uniform(-8, -2, n)))
    big = 10.0 ** rng.uniform(3, 8, (2, k))
    a[k:2 * k], c[k:2 * k] = big
    b[k:2 * k] = rng.uniform(-0.5, 0.5, k) * np.sqrt(big[0] * big[1])
    tiny = 10.0 ** rng.uniform(-40, -6, (2, k))
    a[2 * k:3 * k], c[2 * k:3 * k] = tiny
    b[2 * k:3 * k] = rng.uniform(-0.5, 0.5, k) * np.sqrt(tiny[0] * tiny[1])
    a[3 * k:4 * k] = -10.0 ** rng.uniform(-3, 0, k)
    b[4 * k:] = sgn[4 * k:] * np.sqrt(a[4 * k:] * c[4 * k:] * (
        1 + 10.0 ** rng.uniform(-6, 0, n - 4 * k)))
    return _fields3d(rng.uniform(0, 64, n), rng.uniform(0, 64, n), a, b, c,
                     rng.uniform(0.05, 1.0, n), rng)


def _on_box_gaussians3d(seed=34, n=200):
    """Gaussians whose support box ends exactly on a pixel centre: the mean
    moved (in float32) until the box's right edge (even rows) or top edge
    (odd rows) is a pixel centre of the 64x64 grid."""
    rng = np.random.default_rng(seed)
    a, b, c = _conics(rng, n, log_scale=(-2.0, 0.0), log_kappa=(0.0, 2.0))
    f = _fields3d(rng.uniform(8, 56, n), rng.uniform(8, 56, n), a, b, c,
                  rng.uniform(0.05, 1.0, n), rng)
    edge = torch.where(torch.arange(n) % 2 == 0, 1, 2)
    col = torch.where(edge == 1, 0, 1)
    for _ in range(4):
        box = raster3d.support_box(f)
        at = box.gather(1, edge[:, None])[:, 0]
        f[:, 0:2].scatter_add_(1, col[:, None], (torch.floor(at) + 0.5
                                                 - at)[:, None])
    return f


def _stack_gaussians3d(seed=35):
    """An 800-deep stack of broad opaque gaussians over the whole 64x64
    grid, and 200 gaussians repeated five times at the same mean (ties)."""
    rng = np.random.default_rng(seed)
    n = 800
    stack = _fields3d(rng.uniform(16, 48, n), rng.uniform(16, 48, n),
                      np.full(n, 2e-3), np.zeros(n), np.full(n, 2e-3),
                      np.full(n, 0.95), rng)
    a, b, c = _conics(rng, 200, log_scale=(-1.5, -0.5), log_kappa=(0, 1))
    dup = _fields3d(rng.uniform(0, 64, 200), rng.uniform(0, 64, 200), a, b,
                    c, rng.uniform(0.1, 0.9, 200), rng).repeat_interleave(
                        5, 0)
    return torch.cat([dup, stack])


def _inputs_3dgs(dev, case):
    """K1's inputs: the cloud of `_scene` binned at 64x64 or 200x120, or
    ("margins") the skip tests' gaussians (opacities at the cut-off's
    edges, boxes ending on a pixel centre, degenerate and indefinite
    conics, every conditioning) and then the duplicates and the saturating
    stack, every gaussian in every tile of a 64x64 grid: tile t takes the
    four edge-case groups rotated by t, so that each group comes first,
    before the pixels saturate, in one tile."""
    if case == "margins":
        groups = [_opacity_gaussians3d(), _on_box_gaussians3d(),
                  _degenerate_gaussians3d(), _random_gaussians3d()]
        f = torch.cat([*groups, _stack_gaussians3d()]).to(dev)
        ntx, nty = 2, 2
        ids = torch.arange(f.shape[0], dtype=torch.int32).split(
            [len(g) for g in groups] + [f.shape[0] - sum(map(len, groups))])
        gid = torch.cat([torch.cat([*ids[t:4], *ids[:t], ids[4]])
                         for t in range(ntx * nty)]).to(dev)
        starts = torch.arange(0, gid.shape[0] + 1, f.shape[0],
                              dtype=torch.int32, device=dev)
        return f, gid, starts, ntx, nty
    w, h = (int(x) for x in case.split("x"))
    g = _scene(dev)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=dev)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             w, h)
    return (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)


CASES_3D = ["64x64", "200x120", "margins"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES_3D)
def test_kernel_matches_plain(card, case):
    """K1 against its plain version: acc within 2e-5 (+ rtol 2e-4),
    exp(log T) within 1e-4, i_fin within 1, n_contrib equal or at the stop;
    on the margins case every pixel stops."""
    args = _inputs_3dgs(card, case)
    before = raster3d.KERNEL.launches
    acc_k, logT_k, nc_k = raster3d.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert raster3d.KERNEL.launches == before + 1
    acc_p, logT_p, nc_p = raster3d.rasterize_fwd_plain(*args)
    torch.testing.assert_close(acc_k, acc_p, atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(torch.exp(logT_k[:, 0]),
                               torch.exp(logT_p[:, 0]), atol=1e-4, rtol=0)
    assert (logT_k[:, 1] - logT_p[:, 1]).abs().max() <= 1
    assert raster3d.n_contrib_off_the_stop(*args[:4], nc_k, logT_k[:, 0],
                                           nc_p, logT_p[:, 0]) == 0
    if case == "margins":
        assert (logT_p[:, 0] <= raster3d.LOG_T_EPS).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES_3D)
def test_bwd_kernel_matches_plain(card, case):
    """K2 on K1's own records and seeded cotangents: per field within
    2e-4 x its max |grad| (atomics sum in no fixed order), exact zeros for
    gaussians no pixel walked."""
    args = _inputs_3dgs(card, case)
    _, logT, nc = raster3d.rasterize_fwd(*args)
    gen = torch.Generator().manual_seed(4)
    n_tiles = args[3] * args[4]
    d_acc = torch.randn((n_tiles, raster3d.N_ACC, raster3d.P),
                        generator=gen).to(card)
    d_logT = torch.randn((n_tiles, raster3d.P), generator=gen).to(card)
    b_args = (*args[:3], d_acc, d_logT, logT[:, 0].contiguous(), nc,
              *args[3:])
    before = raster3d.KERNEL_BWD.launches
    got = raster3d.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert raster3d.KERNEL_BWD.launches == before + 1
    want = raster3d.rasterize_bwd_plain(*b_args)
    err = (got - want).abs().amax(0)
    assert (err <= 2e-4 * want.abs().amax(0)).all(), err
    starts = args[2].tolist()
    walked = torch.zeros(args[0].shape[0], dtype=torch.bool, device=card)
    for t in range(n_tiles):
        ids = args[1][starts[t]:starts[t] + int(nc[t].max())]
        walked[ids.long()] = True
    assert (got[~walked] == 0).all()


@pytest.mark.cuda
def test_cuda_render_matches_dense(card):
    from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    cfg = ModelConfig(voxel_size=0.1, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    pts = random_gaussians(500, seed=0, extent=0.8)["means"]
    state = init_anchor_state_from_points(cfg, pts, device=card)
    gen = torch.Generator().manual_seed(0)
    state = state._replace(
        feat=torch.randn(state.feat.shape, generator=gen).to(card),
        offset=torch.randn(state.offset.shape, generator=gen).to(card))
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=gen, device=card)
    cam = lookat_camera(width=96, height=64, eye=(0.5, -1.0, -3.5),
                        device=card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    with torch.no_grad():
        c = render(cam, cfg, mlps, state, bg, rasterizer="cuda")
        d = render(cam, cfg, mlps, state, bg, rasterizer="dense")
    assert int(c["n_dropped"]) == 0
    assert float(c["render_alphas"].max()) > 0.5
    for key in ("render", "render_alphas"):
        torch.testing.assert_close(c[key], d[key], atol=2e-4, rtol=0)
    torch.testing.assert_close(c["render_depth"], d["render_depth"],
                               atol=2e-4, rtol=2e-4)
    assert np.isfinite(c["render"].cpu().numpy()).all()


SURFEL_KEYS = ("means", "quats", "scales", "opacities", "colors")


def _surfels(blocks, w=64, h=64):
    """(N, 18) fields of the numpy surfel blocks seen from the 64x64 test
    camera (every surfel, binned or not)."""
    g = {k: np.concatenate([b[k] for b in blocks]).astype(np.float32)
         for k in SURFEL_KEYS}
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device="cpu")
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    return build_raster_inputs_2dgs(*(t[k] for k in SURFEL_KEYS),
                                    cam.viewmat, cam.K, w, h,
                                    cap=1 << 16).fields


def _about_x(rng, means, angles, scales, opacities):
    n = len(means)
    half = np.asarray(angles) / 2
    return {"means": means,
            "quats": np.stack([np.cos(half), np.sin(half), np.zeros(n),
                               np.zeros(n)], axis=1),
            "scales": np.repeat(np.asarray(scales)[:, None], 3, axis=1),
            "opacities": np.asarray(opacities),
            "colors": rng.uniform(0, 1, (n, 3))}


def _scene_surfels(seed=21):
    """A cloud, surfels within 0.1 degree of edge-on, large tilted surfels
    0.2-0.6 in front of the camera that reach behind it, and faint ones."""
    rng = np.random.default_rng(seed)
    cloud = random_gaussians(150, seed=seed, extent=0.8,
                             scale_range=(0.03, 0.15))
    n = 60
    edge_on = _about_x(rng, np.stack([rng.uniform(-0.6, 0.6, n),
                                      rng.uniform(-0.02, 0.02, n),
                                      rng.uniform(-0.5, 0.5, n)], axis=1),
                       np.radians(90 + rng.uniform(-0.1, 0.1, n)),
                       rng.uniform(0.1, 0.3, n), rng.uniform(0.5, 1.0, n))
    near = _about_x(rng, np.stack([rng.uniform(-0.1, 0.1, 24),
                                   rng.uniform(-0.1, 0.1, 24),
                                   rng.uniform(-3.8, -3.4, 24)], axis=1),
                    rng.uniform(0.3, 1.3, 24), rng.uniform(0.3, 1.5, 24),
                    rng.uniform(0.3, 1.0, 24))
    faint = _about_x(rng, rng.uniform(-0.6, 0.6, (24, 3)),
                     rng.uniform(0, np.pi, 24), rng.uniform(0.1, 0.3, 24),
                     rng.uniform(0.004, 0.02, 24))
    return _surfels([cloud, edge_on, near, faint])


def _min_rho(fields, ntx=2, nty=4):
    """Per surfel, the least min(rho3d, rho2d) over the pixels of the grid
    whose hit lies in front (z > 0.01)."""
    lx, ly = raster2d.local_pixel_coords("cpu")
    best = torch.full((fields.shape[0],), float("inf"))
    for t in range(ntx * nty):
        geo = raster2d.segment_geometry(fields, t, ntx, lx, ly)
        rho = torch.where(geo["use3d"], geo["u"] ** 2 + geo["v"] ** 2,
                          2.0 * (geo["dx"] ** 2 + geo["dy"] ** 2))
        rho = torch.where(geo["z"] > 0.01, rho, torch.full_like(rho, 1e30))
        best = torch.minimum(best, rho.min(0).values)
    return best


def _opacity_surfels():
    """The scene with opacities at the edges of the cut-off: 1/255 and a
    few ulps above or below, near 1, and set so that one pixel's
    op·exp(-rho/2) lands within an ulp or two of 1/255."""
    f = _scene_surfels(seed=22).clone()
    n = f.shape[0]
    ulp = np.float32(2.0 ** -23)
    rho = _min_rho(f).numpy()
    at = C255 * np.exp(np.clip(rho, 0, 11.0) / 2).astype(np.float32)
    choices = [C255 * (1 + k * ulp) for k in (-1, 0, 1, 2, 8)] + \
        [np.float32(0.9999), np.float32(1.0)]
    op = np.empty(n, np.float32)
    for j in range(n):
        if j % 2 and rho[j] < 11.0:          # the boundary at one pixel
            op[j] = at[j] * (1 + ulp * ((j // 2) % 5 - 2))
        else:
            op[j] = choices[j % len(choices)]
    f[:, 11] = torch.from_numpy(op)
    return f


def _kz_surfels(seed=23):
    """Surfels M = [[1, 0, c1], [0, 1, c2], [e, 0, g]] whose k_z = 1 - e·px
    crosses 0 at a column of pixel centres: |k_z| from 1e-11 to 1e-7 there,
    around the 1e-9 gate, with the low-pass centre on that column."""
    rng = np.random.default_rng(seed)
    rows = []
    for j in range(120):
        px0 = float(rng.integers(0, 64)) + 0.5
        kz = 10.0 ** rng.uniform(-11, -7) * rng.choice([-1.0, 1.0])
        e = (1.0 - kz) / px0
        rows.append([1.0, 0.0, rng.uniform(-40, 40),
                     0.0, 1.0, rng.uniform(-40, 40),
                     e, 0.0, rng.uniform(-2.0, 2.0),
                     px0 + rng.uniform(-1, 1), rng.uniform(0, 64),
                     rng.uniform(0.3, 1.0), 0.5, 0.5, 0.5, 0.0, 0.0, 1.0])
    return torch.tensor(rows, dtype=torch.float32)


def _stack_surfels(seed=24):
    """200 large surfels tilted up to 17 degrees from facing the camera,
    stacked in depth over the whole 64x64 view: pixels stop at different
    surfels."""
    rng = np.random.default_rng(seed)
    n = 200
    return _surfels([_about_x(
        rng, np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                       np.linspace(-0.5, 0.5, n)], axis=1),
        rng.uniform(-0.3, 0.3, n), np.full(n, 0.8), np.full(n, 0.95))])


def _inputs_2dgs(dev, case):
    """K3's inputs: the cloud of `_scene` binned at 64x64 or 200x120, or
    ("margins") the skip tests' surfels (|k_z| around the 1e-9 gate,
    opacities at the cut-off's edges, the scene with edge-on and partly
    behind-camera surfels) and then a saturating stack, every surfel in
    every tile of a 64x64 grid in that order."""
    if case == "margins":
        f = torch.cat([_kz_surfels(), _opacity_surfels(), _scene_surfels(),
                       _stack_surfels()]).to(dev)
        ntx, nty = 2, 4
        n = f.shape[0]
        gid = torch.arange(n, dtype=torch.int32, device=dev).repeat(ntx * nty)
        starts = torch.arange(0, n * ntx * nty + 1, n, dtype=torch.int32,
                              device=dev)
        return f, gid, starts, ntx, nty
    w, h = (int(x) for x in case.split("x"))
    g = _scene(dev)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=dev)
    ri = build_raster_inputs_2dgs(g["means"], g["quats"], g["scales"],
                                  g["opacities"], g["colors"], cam.viewmat,
                                  cam.K, w, h)
    return (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)


CASES_2D = ["64x64", "200x120", "margins"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES_2D)
def test_kernel_2d_matches_plain(card, case):
    """K3 against its plain version: acc and aux within 2e-5 (D, the
    distortion and the median depth + rtol 2e-4 of their size), exp(log T)
    within 1e-4, the records equal or at a boundary rounding moves; on
    the margins case every pixel stops."""
    args = _inputs_2dgs(card, case)
    before = raster2d.KERNEL_2D.launches
    acc_k, aux_k, rec_k = raster2d.rasterize2d_fwd(*args)
    torch.cuda.synchronize()
    assert raster2d.KERNEL_2D.launches == before + 1
    acc_p, aux_p, rec_p = raster2d.rasterize2d_fwd_plain(*args)
    torch.testing.assert_close(acc_k, acc_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(aux_k[:, 1:], aux_p[:, 1:], atol=2e-5,
                               rtol=2e-4)
    torch.testing.assert_close(torch.exp(aux_k[:, 0]),
                               torch.exp(aux_p[:, 0]), atol=1e-4, rtol=0)
    assert raster2d.records_off_the_boundary(
        *args[:4], rec_k, aux_k[:, 0], rec_p, aux_p[:, 0]) == (0, 0)
    if case == "margins":
        assert (aux_p[:, 0] <= raster2d.LOG_T_EPS).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES_2D)
def test_bwd_kernel_2d_matches_plain(card, case):
    """K4 on K3's own records and seeded cotangents: per field within
    2e-4 x its max |grad|, exact zeros for surfels no pixel walked."""
    args = _inputs_2dgs(card, case)
    acc, aux, rec = raster2d.rasterize2d_fwd(*args)
    gen = torch.Generator().manual_seed(4)
    n_tiles = args[3] * args[4]
    d_acc = torch.randn((n_tiles, raster2d.N_ACC, raster2d.P),
                        generator=gen).to(card)
    d_aux = torch.randn((n_tiles, raster2d.N_AUX, raster2d.P),
                        generator=gen).to(card)
    b_args = (*args[:3], d_acc, d_aux, acc, aux, rec, *args[3:])
    before = raster2d.KERNEL_2D_BWD.launches
    got = raster2d.rasterize2d_bwd(*b_args)
    torch.cuda.synchronize()
    assert raster2d.KERNEL_2D_BWD.launches == before + 1
    want = raster2d.rasterize2d_bwd_plain(*b_args)
    err = (got - want).abs().amax(0)
    assert (err <= 2e-4 * want.abs().amax(0)).all(), err
    starts = args[2].tolist()
    walked = torch.zeros(args[0].shape[0], dtype=torch.bool, device=card)
    for t in range(n_tiles):
        ids = args[1][starts[t]:starts[t] + int(rec[t, 0].max())]
        walked[ids.long()] = True
    assert (got[~walked] == 0).all()


def _train_setup(dev, W=128, H=72, gs_attr="3D", **optim):
    """The flagship configuration on a small cloud at a small size, with a
    target rendered from other features; the same seeds on any device.
    `optim`: options of `make_optim` beyond start_stat=0."""
    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.data.synthetic import orbit_cameras
    from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.train.step import (
        build_train_step, camera_tensors, init_train_state)
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.05, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0, gs_attr=gs_attr)
    pts = random_gaussians(3000, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    state = init_anchor_state_from_points(cfg, pts, device=dev)
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(state.capacity) < state.n)[:, None]
    feat = torch.randn(state.feat.shape, generator=gen) * live
    offset = torch.randn(state.offset.shape, generator=gen) * live[:, :, None]
    state = state._replace(feat=feat.to(dev), offset=offset.to(dev))
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=gen, device=dev)
    cam = orbit_cameras(1, radius=3.5, height_z=-1.0, width=W, height=H,
                        device=dev)[0]
    feat1 = torch.randn(state.feat.shape,
                        generator=torch.Generator().manual_seed(1)) * live
    with torch.no_grad():
        target = render(cam, cfg, mlps, state._replace(feat=feat1.to(dev)),
                        torch.zeros(3, device=dev))["render"]
    step = build_train_step(cfg, make_optim(start_stat=0, **optim), H, W,
                            add_prefilter=True, rasterizer="cuda")
    return step, init_train_state(state, mlps), camera_tensors(
        cam, image=target, do_stats=True)


NORMAL_LOSS = dict(lambda_normal=0.05, normal_start_iter=0)
SURFEL_LOSSES = dict(NORMAL_LOSS, lambda_dist=0.01, dist_start_iter=0)


@pytest.mark.cuda
@pytest.mark.parametrize("gs_attr, optim", [("3D", {}), ("2D", NORMAL_LOSS)],
                         ids=["3dgs", "2dgs_normal"])
def test_train_step_matches_cpu(card, gs_attr, optim):
    """One step of the flagship configuration through K1/K2 (3DGS) or
    K3/K4 (2DGS, the normal loss on) on the card against the same step
    through their plain versions on the CPU: loss and metrics rtol 1e-5,
    gradients per tensor within 2e-4 x its max |grad|, statistics within
    2e-4 x their max. (The distortion loss is held on the card's own
    inputs below: on this scene its gradient moves by the order of its
    max under a 1e-6 relative change of the decoders' weights, through
    surfels seen nearly edge-on, so no two devices agree on it.)"""
    results = {}
    for dev in (card, torch.device("cpu")):
        step, ts, ct = _train_setup(dev, gs_attr=gs_attr, **optim)
        _, _, _, grads, probe_grad = step.value_and_grad(ts, ct, 1.0)
        ts, m = step(ts, ct, 1.0)
        results[dev.type] = (grads, probe_grad, ts.stats, m)
    (g_c, p_c, s_c, m_c), (g_h, p_h, s_h, m_h) = (results["cuda"],
                                                  results["cpu"])
    for k in m_h:
        np.testing.assert_allclose(float(m_c[k]), float(m_h[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(m_c["n_dropped"]) == 0
    pairs = [(f"{k}[{i}]", a.cpu(), b) for k in g_h
             for i, (a, b) in enumerate(zip(g_c[k], g_h[k]))]
    pairs += [("probe", p_c.cpu(), p_h)]
    pairs += [(f, getattr(s_c, f).cpu(), getattr(s_h, f))
              for f in s_h._fields]
    for name, a, b in pairs:
        assert (a - b).abs().max() <= 2e-4 * b.abs().max(), name


@pytest.mark.cuda
def test_train_step_2d_kernels_match_plain(card):
    """The 2DGS step with the normal and distortion losses on: K3 and K4
    each launched once, loss and every gradient finite, and K4 against its
    plain version on the step's own inputs and cotangents, per field
    within 2e-4 x its max |grad|."""
    from horizongs_tpu_torch.ops import raster_cuda
    step, ts, ct = _train_setup(card, gs_attr="2D", **SURFEL_LOSSES)
    captured = []
    bwd = raster_cuda.rasterize2d_bwd

    def capture(*args):
        captured.append(args)
        return bwd(*args)

    launches = (raster2d.KERNEL_2D.launches, raster2d.KERNEL_2D_BWD.launches)
    raster_cuda.rasterize2d_bwd = capture
    try:
        loss, _, pkg, grads, probe_grad = step.value_and_grad(ts, ct, 1.0)
    finally:
        raster_cuda.rasterize2d_bwd = bwd
    torch.cuda.synchronize()
    assert (raster2d.KERNEL_2D.launches - launches[0],
            raster2d.KERNEL_2D_BWD.launches - launches[1]) == (1, 1)
    assert float(pkg["render_distort"].abs().max()) > 0
    assert torch.isfinite(loss) and torch.isfinite(probe_grad).all()
    for k, gs in grads.items():
        assert all(bool(torch.isfinite(g).all()) for g in gs), k
    got = raster2d.rasterize2d_bwd(*captured[0])
    want = raster2d.rasterize2d_bwd_plain(*captured[0])
    err = (got - want).abs().amax(0)
    assert (err <= 2e-4 * want.abs().amax(0)).all(), err


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_persistent_fwd_equals_k1(card, size):
    """T1 under both schedules, launched twice each (a counter left at its
    last value would walk nothing the second time): acc, log T, i_fin and
    n_contrib bit for bit K1's."""
    w, h = size
    g = _scene(card)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             w, h)
    args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    ref = raster3d.rasterize_fwd(*args)
    for schedule in raster3d.SCHEDULES:
        for _ in range(2):
            before = raster3d.KERNEL_PERSISTENT.launches
            got = raster3d.rasterize_fwd_persistent(*args, schedule=schedule)
            torch.cuda.synchronize()
            assert raster3d.KERNEL_PERSISTENT.launches == before + 1
            assert 0 < raster3d.persistent_grid(
                ri.grid.n_tiles, schedule, card) <= ri.grid.n_tiles
            for a, b in zip(got, ref):
                assert torch.equal(a, b), schedule


@pytest.mark.cuda
def test_bwd_variants(card):
    """T2: "full" is K2 within 2e-4 x max |grad| per field; each stripped
    variant runs at K2's blocks per SM, launches once and stores nothing,
    but no_color, which adds the six geometric gradients only."""
    from horizongs_tpu_torch.tools.profile_bwd_variants import bwd_scene
    args, _ = bwd_scene(2000, 128, 96, device=card)
    want = raster3d.rasterize_bwd(*args)
    got = raster3d.rasterize_bwd_variant("full", *args)
    err = (got - want).abs().amax(0)
    assert (err <= 2e-4 * want.abs().amax(0)).all(), err
    index = torch.cuda.current_device()
    k2_pad, k2_blocks = raster3d.variant_occupancy("full", index)
    assert k2_pad == 0 and k2_blocks > 0
    for v in raster3d.VARIANTS[1:]:
        assert raster3d.variant_occupancy(v, index)[1] == k2_blocks, v
        k = raster3d.KERNELS_BWD_VARIANT[v]
        before = k.launches
        out = raster3d.rasterize_bwd_variant(v, *args)
        torch.cuda.synchronize()
        assert k.launches == before + 1
        if v == "no_color":
            assert bool(out[:, :6].any()) and not bool(out[:, 6:].any())
        else:
            assert not bool(out.any()), v


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [3, 255])
def test_grid_overhead_matches_plain(card, n_blocks):
    from horizongs_tpu_torch.ops import grid_overhead as go
    inst = torch.randn((go.ROWS, 4096), generator=torch.Generator()
                       .manual_seed(5)).to(card)
    out = torch.full((n_blocks, go.ROWS, go.P), 7.0, device=card)
    go.write(out)
    assert torch.equal(out, go.write_plain(n_blocks, card))
    go.one_copy(inst, out)
    assert torch.equal(out, go.one_copy_plain(inst, n_blocks))
    before = go.KERNEL_EMPTY.launches
    go.empty(n_blocks, card)
    torch.cuda.synchronize()
    assert go.KERNEL_EMPTY.launches == before + 1


@pytest.mark.cuda
def test_densify_matches_cpu_copy(card):
    """Four steps of the flagship configuration on the card (statistics
    gates opened for them), then one coarse densify epoch on the card and
    the same epoch on a CPU copy of the state: equal n, levels, tables,
    moments and statistics."""
    from horizongs_tpu_torch.convert import (
        train_state_to_device, train_state_to_numpy)
    from horizongs_tpu_torch.train.densify import run_densify
    step, ts, ct = _train_setup(card, update_interval=2,
                                success_threshold=0.5)
    for it in range(1, 5):
        ts, _ = step(ts, ct, it)
    host = train_state_to_device(ts, "cpu")
    rep_c, rep_h = {}, {}
    out_c = run_densify(step.cfg, step.opt, ts, 4, report=rep_c)
    out_h = run_densify(step.cfg, step.opt, host, 4, report=rep_h)
    assert rep_c["added"] == rep_h["added"] > 0
    assert rep_c["pruned"] == rep_h["pruned"]
    a, b = train_state_to_numpy(out_c), train_state_to_numpy(out_h)

    def flat(d, prefix=""):
        for key, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{key}.")
            elif v is not None:
                yield f"{prefix}{key}", np.asarray(v)
    want = dict(flat(b))
    for name, got in flat(a):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
