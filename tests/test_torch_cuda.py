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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_kernel_matches_plain(card, size):
    w, h = size
    g = _scene(card)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             w, h)
    args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)
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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_bwd_kernel_matches_plain(card, size):
    """K2 on K1's own records and seeded cotangents: per field within
    2e-4 x its max |grad| (atomics sum in no fixed order), exact zeros for
    gaussians no pixel walked."""
    w, h = size
    g = _scene(card)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             w, h)
    args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    _, logT, nc = raster3d.rasterize_fwd(*args)
    gen = torch.Generator().manual_seed(4)
    n_tiles = ri.grid.n_tiles
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
    starts = ri.inst.tile_starts.tolist()
    walked = torch.zeros(ri.fields.shape[0], dtype=torch.bool, device=card)
    for t in range(n_tiles):
        ids = ri.inst.gauss_id[starts[t]:starts[t] + int(nc[t].max())]
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


def _inputs_2dgs(dev, w, h):
    g = _scene(dev)
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=dev)
    ri = build_raster_inputs_2dgs(g["means"], g["quats"], g["scales"],
                                  g["opacities"], g["colors"], cam.viewmat,
                                  cam.K, w, h)
    return (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_kernel_2d_matches_plain(card, size):
    """K3 against its plain version: acc and aux within 2e-5 (D, the
    distortion and the median depth + rtol 2e-4 of their size), exp(log T)
    within 1e-4, the records equal or at a boundary rounding moves."""
    args = _inputs_2dgs(card, *size)
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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (200, 120)])
def test_bwd_kernel_2d_matches_plain(card, size):
    """K4 on K3's own records and seeded cotangents: per field within
    2e-4 x its max |grad|, exact zeros for surfels no pixel walked."""
    args = _inputs_2dgs(card, *size)
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
