"""Port parity, training: LR schedules, Adam, the densification statistics
and one `build_train_step` step against the JAX package's, from a state
carried across by `convert.py`; and a port-only run that fits a scene.

The JAX step runs its Pallas rasterizer in interpret mode and its SSIM
blur as a float32 product (`test_torch_losses.f32_blur`: the bf16x3 split
the port does not carry gives the JAX SSIM gradient bf16 accuracy only).
Tolerances: loss and metrics rtol 1e-5; gradients per tensor within
2e-4 x its max |grad| (sums in other orders, K2's atomics on the card);
parameters after the step only where |grad| > 1e-3 x the tensor's max,
since Adam's first step is +-lr x sign(g) and a near-zero gradient may
take the other sign in the other framework."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.config import make_optim as j_make_optim
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.models import init_anchor_state_from_points as j_init_state
from horizongs_tpu.models import init_mlps as j_init_mlps
from horizongs_tpu.ops.reference import render_dense_3dgs as j_dense
from horizongs_tpu.train import optim as jopt
from horizongs_tpu.train import schedules as jsch
from horizongs_tpu.train import step as jstep
from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.convert import train_state_from_numpy, train_state_to_numpy
from horizongs_tpu_torch.data.synthetic import orbit_cameras, random_gaussians
from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import init_mlps
from horizongs_tpu_torch.train import optim as topt
from horizongs_tpu_torch.train import schedules as tsch
from horizongs_tpu_torch.train import step as tstep
from test_torch_losses import f32_blur  # noqa: F401  (fixture)
from test_torch_raster2d import safe_depth_normals  # noqa: F401  (fixture)

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

W = H = 48


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("step", [0, 1, 250, 1999, 30000, 80000])
def test_group_lrs_match(step):
    opt_j = j_make_optim(iterations=2000, position_lr_init=1e-3,
                         position_lr_final=1e-5, appearance_lr_init=0.05,
                         appearance_lr_final=5e-4)
    opt_t = make_optim(**vars(opt_j))
    lj = jsch.group_lrs(opt_j, step, 2.5)
    lt = tsch.group_lrs(opt_t, step, 2.5)
    assert set(lj) == set(lt)
    for k in lj:
        np.testing.assert_allclose(lt[k], float(lj[k]), rtol=2e-6, atol=0,
                                   err_msg=k)
    for init, final, delay in ((0.01, 1e-4, 0), (0.0, 0.0, 0), (0.0, 1e-3, 0),
                               (2e-3, 2e-5, 500)):
        np.testing.assert_allclose(
            tsch.expon_lr(step, init, final, lr_delay_steps=delay,
                          lr_delay_mult=0.01, max_steps=30000),
            float(jsch.expon_lr(step, init, final, lr_delay_steps=delay,
                                lr_delay_mult=0.01, max_steps=30000)),
            rtol=2e-6, atol=0)


def _j_train_state(cfg, pts, capacity, seed=0, noise=0.0):
    state = j_init_state(cfg, pts, capacity=capacity)
    mlps = j_init_mlps(jax.random.PRNGKey(seed), cfg.feat_dim, cfg.view_dim,
                       cfg.appearance_dim, cfg.n_offsets, cfg.color_dim,
                       num_cameras=8)
    rng = np.random.default_rng(seed)
    live = (np.arange(state.capacity) < int(state.n))[:, None]
    feat = rng.normal(size=state.feat.shape).astype(np.float32) * live
    offset = (noise * rng.normal(size=state.offset.shape).astype(np.float32)
              * live[:, :, None])
    params = jopt.TrainableParams(
        anchor=state.anchor, offset=jnp.asarray(offset),
        feat=jnp.asarray(feat), scaling_log=state.scaling_log,
        mlp_opacity=mlps.opacity, mlp_cov=mlps.cov, mlp_color=mlps.color,
        appearance=mlps.appearance)
    return jstep.TrainState(params=params, rotation=state.rotation,
                            level=state.level, extra_level=state.extra_level,
                            n=state.n, opt=jopt.init_adam(params),
                            stats=jstep.init_stats(state.capacity,
                                                   cfg.n_offsets))


def _leaves(groups_np):
    """{group: array or MLP dict} -> {name: array}, appearance skipped."""
    out = {}
    for k, v in groups_np.items():
        if isinstance(v, dict):
            for l, d in v.items():
                for q, a in d.items():
                    out[f"{k}.{l}.{q}"] = a
        elif v is not None:
            out[k] = v
    return out


def _j_groups(tp):
    return {f: getattr(tp, f) for f in tp._fields}


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "frozen_mlps"])
def test_adam_step_matches(frozen):
    cfg = JConfig(name="GaussianModel", feat_dim=8, n_offsets=3,
                  appearance_dim=4, voxel_size=0.2)
    pts = np.random.default_rng(0).uniform(-1, 1, (60, 3)).astype(np.float32)
    ts_j = _j_train_state(cfg, pts, capacity=64, noise=0.5)
    ts_t = train_state_from_numpy(_np(ts_j), device="cpu")
    opt = j_make_optim()
    rng = np.random.default_rng(1)
    p_j, o_j = ts_j.params, ts_j.opt
    o_t = ts_t.opt
    for it in (1.0, 2.0, 3.0):
        g_np = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), _np(p_j))
        lrs = jopt.lr_tree(p_j, jsch.group_lrs(opt, it, 1.0),
                           frozen_mlps=frozen)
        p_j, o_j = jax.jit(jopt.adam_step)(
            p_j, jax.tree.map(jnp.asarray, g_np), o_j, lrs)
        grads = train_state_from_numpy(
            _np(ts_j._replace(params=g_np)), device="cpu").params.groups()
        lt = topt.lr_groups(tsch.group_lrs(make_optim(), it, 1.0),
                            frozen_mlps=frozen)
        o_t = topt.adam_step(ts_t.params, grads, o_t, lt)
    assert o_t.t == int(o_j.t) == 3
    got = train_state_to_numpy(ts_t._replace(opt=o_t))
    for part, want in (("params", p_j), ("mu", o_j.mu), ("nu", o_j.nu)):
        w = _leaves(_np(_j_groups(want)))
        g = _leaves(got[part])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-7, rtol=0,
                                       err_msg=f"{part} {k}")
    app = got["params"]["appearance"]
    assert app is not None
    mlp0 = _leaves(_np(_j_groups(ts_j.params)))["mlp_cov.l1.w"]
    if frozen:     # LR 0: frozen weights stay, their moments move
        np.testing.assert_array_equal(got["params"]["mlp_cov"]["l1"]["w"],
                                      mlp0)
        assert np.abs(got["mu"]["mlp_cov"]["l1"]["w"]).max() > 0


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_update_stats_matches(mode):
    C, k = 50, 4
    rng = np.random.default_rng(2)
    opt_j = j_make_optim(growing_type=mode, pruning_type=mode)
    opt_t = make_optim(growing_type=mode, pruning_type=mode)
    stats = [rng.uniform(0, 2, n).astype(np.float32)
             for n in (C, C, C * k, C * k, C * k, C * k)]
    args = dict(
        opacities=rng.uniform(-0.2, 1, C * k).astype(np.float32),
        selection_mask=rng.uniform(size=C * k) > 0.3,
        anchor_mask=rng.uniform(size=C) > 0.2,
        radii=np.where(rng.uniform(size=C * k) > 0.25,
                       rng.integers(1, 9, C * k), 0).astype(np.float32),
        means2d_grad=rng.normal(size=(C * k, 2)).astype(np.float32) * 1e-3)
    for gate in (1.0, 0.0):
        sj = jstep.update_stats(opt_j, jstep.DensifyStats(*map(jnp.asarray,
                                                             stats)),
                                k, width=W, height=H, gate=jnp.float32(gate),
                                **{a: jnp.asarray(v) for a, v in
                                   args.items()})
        st = tstep.update_stats(opt_t, tstep.DensifyStats(
            *map(torch.from_numpy, stats)), k, width=W, height=H, gate=gate,
            **{a: torch.from_numpy(v) for a, v in args.items()})
        for f in jstep.DensifyStats._fields:
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(sj, f)), atol=1e-6,
                                       rtol=1e-6, err_msg=f)
        if gate == 0.0:
            for f in jstep.DensifyStats._fields:
                np.testing.assert_array_equal(
                    getattr(st, f).numpy(),
                    stats[jstep.DensifyStats._fields.index(f)])


def _targets(n_cams=4, seed=0):
    """Target images: dense renders of a seeded cloud, made by the JAX
    package; returns them with the cloud's means."""
    g = random_gaussians(40, seed=seed, extent=0.7, scale_range=(0.08, 0.2))
    cams = orbit_cameras(n_cams, radius=3.5, height_z=-1.0, width=W,
                         height=H, device="cpu")
    bg = jnp.zeros(3)
    images = [np.array(j_dense(*(jnp.asarray(g[k]) for k in (
        "means", "quats", "scales", "opacities", "colors")),
        jnp.asarray(c.viewmat.numpy()), jnp.asarray(c.K.numpy()), W, H,
        bg)[0]) for c in cams]
    return cams, images, g["means"]


FLAT = dict(name="GaussianModel", feat_dim=16, n_offsets=4, view_dim=3,
            color_attr="RGB", render_mode="RGB", voxel_size=0.1)
LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           color_attr="RGB", render_mode="RGB+ED", voxel_size=0.3, fork=2,
           aerial_levels=2, street_levels=4, standard_dist=8.0)


SURFEL_LOSSES = dict(lambda_normal=0.05, normal_start_iter=0,
                     lambda_dist=0.01, dist_start_iter=0)


@pytest.mark.parametrize("cfg_kw, prefilter, loss_kw",
                         [(FLAT, False, {}), (LOD, True, {}),
                          (dict(LOD, gs_attr="2D"), True, SURFEL_LOSSES)],
                         ids=["flat_48x48", "lod_48x48_prefilter",
                              "lod_2dgs_48x48_normal_dist"])
def test_train_step_matches_jax(cfg_kw, prefilter, loss_kw, f32_blur,
                                safe_depth_normals):
    okw = dict(iterations=2000, start_stat=0, feature_lr=0.03,
               mlp_color_lr_init=0.02, mlp_opacity_lr_init=0.01, **loss_kw)
    cams, images, pts = _targets()
    ts_j = _j_train_state(JConfig(**cfg_kw), pts, capacity=256, noise=0.3)
    ts_t = train_state_from_numpy(_np(ts_j), device="cpu")
    it, cam = 3, cams[3]
    j_cam = jstep.CameraTensors(
        viewmat=jnp.asarray(cam.viewmat.numpy()), K=jnp.asarray(cam.K.numpy()),
        cam_center=jnp.asarray(cam.cam_center.numpy()), uid=jnp.int32(0),
        image=jnp.asarray(images[3]), alpha_mask=jnp.ones((H, W, 1)),
        invdepth=jnp.zeros((H, W, 1)), depth_mask=jnp.zeros((H, W, 1)),
        has_depth=jnp.float32(0), do_stats=jnp.float32(1),
        resolution_scale=jnp.float32(1), loss_weight=jnp.float32(1))
    t_cam = tstep.camera_tensors(cam, image=torch.from_numpy(images[3]),
                                 do_stats=True)
    step_j = jstep.build_train_step(JConfig(**cfg_kw), j_make_optim(**okw),
                                    H, W, add_prefilter=prefilter,
                                    rasterizer="pallas_interpret")
    step_t = tstep.build_train_step(ModelConfig(**cfg_kw), make_optim(**okw),
                                    H, W, add_prefilter=prefilter,
                                    rasterizer="cuda")
    ts_j2, m_j = step_j(ts_j, j_cam, it)
    ts_t2, m_t = step_t(ts_t, t_cam, it)

    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(m_t["n_selected"]) > 0 and int(m_t["n_dropped"]) == 0
    got = train_state_to_numpy(ts_t2)
    assert got["t"] == int(ts_j2.opt.t) == 1
    # Adam's first step from zero moments: mu = (1 - b1) g
    g_j = {k: v / 0.1 for k, v in _leaves(_np(_j_groups(ts_j2.opt.mu)))
           .items()}
    g_t = {k: v / 0.1 for k, v in _leaves(got["mu"]).items()}
    p_j = _leaves(_np(_j_groups(ts_j2.params)))
    p_t = _leaves(got["params"])
    for k in g_j:
        scale = np.abs(g_j[k]).max()
        assert scale > 0, k
        assert np.abs(g_t[k] - g_j[k]).max() <= 2e-4 * scale, k
        big = np.abs(g_j[k]) > 1e-3 * scale
        np.testing.assert_allclose(p_t[k][big], p_j[k][big], atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    s_j = _np(ts_j2.stats)
    for f in jstep.DensifyStats._fields:
        want = getattr(s_j, f)
        np.testing.assert_allclose(got["stats"][f], want, rtol=0,
                                   atol=2e-4 * max(np.abs(want).max(), 1e-30),
                                   err_msg=f)
    assert s_j.offset_gradient_accum.max() > 0


def test_training_reduces_loss():
    """`test_train_e2e.test_training_reduces_loss`, in the port: 120 steps
    of the 48x48 flat model through K1/K2's plain versions."""
    cfg = ModelConfig(**FLAT)
    opt = make_optim(iterations=2000, lambda_dreg=0.0, lambda_sky_opa=0.0,
                     lambda_opacity_entropy=0.0, start_stat=0,
                     feature_lr=0.03, mlp_color_lr_init=0.02,
                     mlp_opacity_lr_init=0.01)
    cams, images, pts = _targets()
    state = init_anchor_state_from_points(cfg, pts, capacity=256,
                                          device="cpu")
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ts = tstep.init_train_state(state, mlps)
    step = tstep.build_train_step(cfg, opt, H, W, add_prefilter=False)
    cam_ts = [tstep.camera_tensors(c, image=torch.from_numpy(im),
                                   do_stats=True)
              for c, im in zip(cams, images)]
    losses = []
    for it in range(1, 121):
        ts, metrics = step(ts, cam_ts[it % len(cam_ts)], it)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    assert last < first * 0.7, f"loss did not decrease: {first} -> {last}"
    assert float(ts.stats.anchor_demon.sum()) > 0
    assert float(ts.stats.offset_denom.sum()) > 0
    for leaf in ts.params.groups().values():
        for t in leaf:
            assert torch.isfinite(t).all()


def test_training_2dgs_reduces_loss():
    """The surfel model fits the scene too: 60 steps of the 48x48 flat
    model as 2DGS through K3/K4's plain versions, the normal and distortion
    losses on from step 10."""
    cfg = ModelConfig(**dict(FLAT, gs_attr="2D"))
    opt = make_optim(iterations=2000, lambda_dreg=0.0, lambda_sky_opa=0.0,
                     lambda_opacity_entropy=0.0, start_stat=0,
                     feature_lr=0.03, mlp_color_lr_init=0.02,
                     mlp_opacity_lr_init=0.01, lambda_normal=0.05,
                     normal_start_iter=10, lambda_dist=0.01,
                     dist_start_iter=10)
    cams, images, pts = _targets()
    state = init_anchor_state_from_points(cfg, pts, capacity=256,
                                          device="cpu")
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ts = tstep.init_train_state(state, mlps)
    step = tstep.build_train_step(cfg, opt, H, W, add_prefilter=False)
    cam_ts = [tstep.camera_tensors(c, image=torch.from_numpy(im),
                                   do_stats=True)
              for c, im in zip(cams, images)]
    losses = []
    for it in range(1, 61):
        ts, metrics = step(ts, cam_ts[it % len(cam_ts)], it)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    assert last < first * 0.8, f"loss did not decrease: {first} -> {last}"
    assert float(ts.stats.offset_denom.sum()) > 0
    for leaf in ts.params.groups().values():
        for t in leaf:
            assert torch.isfinite(t).all()


def test_dense_rasterizer_step_runs():
    """`rasterizer="dense"`: the oracle differentiates through autograd."""
    cfg = ModelConfig(**FLAT)
    cams, images, pts = _targets(n_cams=1)
    state = init_anchor_state_from_points(cfg, pts, capacity=256,
                                          device="cpu")
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ts = tstep.init_train_state(state, mlps)
    cam = tstep.camera_tensors(cams[0], image=torch.from_numpy(images[0]),
                               do_stats=True)
    steps = {r: tstep.build_train_step(cfg, make_optim(start_stat=0), H, W,
                                       add_prefilter=False, rasterizer=r)
             for r in ("dense", "cuda")}
    m = {r: s.value_and_grad(ts, cam, 1.0) for r, s in steps.items()}
    np.testing.assert_allclose(float(m["dense"][0]), float(m["cuda"][0]),
                               rtol=1e-5)
    for k in ("anchor", "feat"):
        a, b = m["dense"][3][k][0], m["cuda"][3][k][0]
        assert (a - b).abs().max() <= 2e-4 * b.abs().max(), k
    with pytest.raises(ValueError):
        tstep.build_train_step(cfg, make_optim(), H, W, rasterizer="tiled")
