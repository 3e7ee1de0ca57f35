"""Port parity, densification: `run_densify`, `pad_state_capacity`,
`clean_stats`, `roll_back` and `weed_out_mask` against the JAX package's,
on the same seeded numpy training state carried across by `convert.py`,
compared exactly (row order, tables, moments, statistics, levels,
extra_level, rotation and n); and a train -> densify -> train run of the
port through K1 and K2's plain versions.

The statistics are drawn far from every threshold (grads either 0, well
below or well above it; opacities well off 0.15; visit counts well off
update_interval x success_threshold). The max-growing decision raises the
opacity to the power 1/5, which the two frameworks round differently in
the last place; drawn so, no such difference can flip a decision."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.config import make_optim as j_make_optim
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.models import init_anchor_state_from_points as j_init_state
from horizongs_tpu.models import init_mlps as j_init_mlps
from horizongs_tpu.models.anchors import weed_out_mask as j_weed_out_mask
from horizongs_tpu.train import densify as jdens
from horizongs_tpu.train import optim as jopt
from horizongs_tpu.train import step as jstep
from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from horizongs_tpu_torch.models.anchors import weed_out_mask
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.train import densify as tdens

torch.set_num_threads(1)

FLAT = dict(name="GaussianModel", feat_dim=8, n_offsets=4, view_dim=3,
            voxel_size=0.05, update_depth=3, update_init_factor=16,
            update_hierachy_factor=4)
LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           voxel_size=0.2, fork=2, aerial_levels=2, street_levels=4,
           standard_dist=8.0)
# update_interval 10 x success_threshold 0.8: anchors count as observed
# above 8 visits, offsets above 4
OPT = dict(update_interval=10, success_threshold=0.8,
           densify_grad_threshold=0.0002)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j_state(cfg_kw, capacity, seed, growing="mean", pruning="mean",
             street_share=0.0, n_pts=300):
    """A JAX `TrainState` with every leaf drawn from `seed`: tables,
    moments (so their row surgery shows), rotation, extra_level, and
    statistics far from every threshold."""
    cfg = JConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    st = j_init_state(cfg, pts, capacity=capacity)
    C, k, n = capacity, cfg.n_offsets, int(st.n)
    live = np.arange(C) < n

    def draw(shape, scale=1.0):
        a = rng.normal(size=shape).astype(np.float32) * scale
        return a * live.reshape((C,) + (1,) * (len(shape) - 1))

    level = np.asarray(st.level).copy()
    if street_share > 0:
        street = live & (rng.uniform(size=C) < street_share)
        level[street] = rng.integers(cfg.aerial_levels, cfg.street_levels,
                                     street.sum())
    mlps = j_init_mlps(jax.random.PRNGKey(seed), cfg.feat_dim, cfg.view_dim,
                       cfg.appearance_dim, cfg.n_offsets, cfg.color_dim)
    params = jopt.TrainableParams(
        anchor=np.asarray(st.anchor), offset=draw((C, k, 3), 2.0),
        feat=draw((C, cfg.feat_dim)),
        scaling_log=np.asarray(st.scaling_log) + draw((C, 6), 0.3),
        mlp_opacity=mlps.opacity, mlp_cov=mlps.cov, mlp_color=mlps.color,
        appearance=mlps.appearance)
    params = _np(params)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      params)
    nu = jax.tree.map(lambda a: rng.uniform(size=a.shape).astype(np.float32),
                      params)
    quat = rng.normal(size=(C, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rotation = np.where(live[:, None], quat, np.float32([1, 0, 0, 0]))

    live_k = np.repeat(live, k)
    od = rng.choice(np.float32([0, 2, 10]), C * k) * live_k
    grads = rng.choice(np.float32([0, 1e-6, 5e-3, 2e-2]), C * k)
    og = (grads * od if growing == "mean" else grads * live_k)
    opac = rng.choice(np.float32([0.05, 0.5]), C * k)
    ooa = opac * od
    radii = rng.uniform(1, 5, C * k).astype(np.float32) * live_k
    adem = rng.choice(np.float32([0, 5, 20]), C) * live
    if pruning == "mean":
        aopa = rng.choice(np.float32([0.001, 2.0]), C) * adem
    else:
        aopa = rng.choice(np.float32([0.001, 0.5]), C) * live
    stats = jstep.DensifyStats(
        anchor_opacity_accum=aopa.astype(np.float32),
        anchor_demon=adem.astype(np.float32),
        offset_gradient_accum=og.astype(np.float32),
        offset_denom=od.astype(np.float32),
        offset_opacity_accum=ooa.astype(np.float32),
        max_radii2d=radii)
    ts = jstep.TrainState(
        params=params, rotation=rotation.astype(np.float32),
        level=level.astype(np.int32),
        extra_level=draw((C,), 0.2).astype(np.float32),
        n=np.int32(n),
        opt=jopt.AdamState(mu=mu, nu=nu, t=np.int32(7)), stats=stats)
    return cfg, jax.tree.map(jnp.asarray, ts)


def _leaves(d, prefix=""):
    """Nested dicts of arrays -> {dotted name: array}; None skipped."""
    out = {}
    for key, v in d.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{key}."))
        elif v is not None:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def _j_as_dict(ts_j):
    """A JAX `TrainState` in `train_state_to_numpy`'s layout."""
    ts = _np(ts_j)
    groups = lambda tp: {f: getattr(tp, f) for f in tp._fields}
    return {"params": groups(ts.params), "mu": groups(ts.opt.mu),
            "nu": groups(ts.opt.nu), "t": int(ts.opt.t),
            "stats": groups(ts.stats), "rotation": ts.rotation,
            "level": ts.level, "extra_level": ts.extra_level,
            "n": int(ts.n)}


def assert_same_state(ts_t, ts_j):
    got, want = _leaves(train_state_to_numpy(ts_t)), _leaves(_j_as_dict(ts_j))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def _both(cfg_kw, capacity, seed, **kw):
    cfg_j, ts_j = _j_state(cfg_kw, capacity, seed, **kw)
    return (cfg_j, ts_j, ModelConfig(**cfg_kw),
            train_state_from_numpy(_np(ts_j), device="cpu"))


CASES = {
    # name: (config, capacity, make_optim options, state options, run_densify
    # options)
    "flat_mean_rng": (FLAT, 1024, dict(growing_type="mean"), {},
                      dict(stage="coarse", rng=1)),
    "lod_coarse_max": (LOD, 512, dict(growing_type="max", pruning_type="max"),
                       dict(growing="max", pruning="max"),
                       dict(stage="coarse")),
    "lod_fine_weed": (LOD, 512, dict(growing_type="mean"),
                      dict(street_share=0.3),
                      dict(stage="fine", weed_ratio=0.3, cams=True)),
    "past_capacity": (LOD, None, dict(growing_type="mean"), {},
                      dict(stage="coarse", capacity_block=64)),
    "adds_nothing": (LOD, 512, dict(densify_grad_threshold=10.0), {},
                     dict(stage="coarse")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_densify_matches_jax(case):
    cfg_kw, capacity, okw, skw, dkw = CASES[case]
    dkw = dict(dkw)
    if capacity is None:           # the table is full: growth must resize
        cfg_j, ts_j = _j_state(cfg_kw, 512, 5, **skw)
        capacity = int(ts_j.n)
    cfg_j, ts_j, cfg_t, ts_t = _both(cfg_kw, capacity, 5, **skw)
    okw = {**OPT, **okw}
    opt_j, opt_t = j_make_optim(**okw), make_optim(**okw)
    if dkw.pop("cams", False):
        r = np.random.default_rng(9)
        dkw["cam_infos"] = np.concatenate(
            [r.uniform(-1.5, 1.5, (12, 3)), np.ones((12, 1))],
            axis=1).astype(np.float32)
    seed = dkw.pop("rng", None)
    rng = (lambda: None) if seed is None else (
        lambda: np.random.default_rng(seed))
    out_j = jdens.run_densify(cfg_j, opt_j, ts_j, 100, rng=rng(), **dkw)
    report = {}
    out_t = tdens.run_densify(cfg_t, opt_t, ts_t, 100, rng=rng(),
                              report=report, **dkw)
    assert_same_state(out_t, out_j)
    added, removed = report["added"], report["pruned"]
    assert out_t.n == ts_t.n + added - removed
    assert min(report[f"{p}_ms"] for p in ("decision", "grow", "repack")) > 0
    if case == "adds_nothing":
        assert added == 0
    else:
        assert added > 0, case
    if case in ("flat_mean_rng", "lod_coarse_max", "lod_fine_weed"):
        assert removed > 0, case
    if case == "past_capacity":
        assert out_t.params.anchor.shape[0] > capacity
        assert out_t.params.anchor.shape[0] % 64 == 0
    for t in (out_t.params.anchor, out_t.params.offset, out_t.params.feat,
              out_t.params.scaling_log):
        assert t.is_leaf and t.requires_grad
    # the input state is left as it was
    assert_same_state(ts_t, ts_j)


def test_run_densify_decimation_follows_the_rng():
    """The flat model's random decimation draws from the generator it is
    given, in the JAX package's order: other seeds, other rows."""
    cfg_j, ts_j, cfg_t, ts_t = _both(FLAT, 1024, 5)
    opt = make_optim(**OPT)
    a = tdens.run_densify(cfg_t, opt, ts_t, 100,
                          rng=np.random.default_rng(1))
    b = tdens.run_densify(cfg_t, opt, ts_t, 100,
                          rng=np.random.default_rng(2))
    assert not torch.equal(a.params.anchor[:a.n], b.params.anchor[:b.n])
    out_j = jdens.run_densify(cfg_j, j_make_optim(**OPT), ts_j, 100,
                              rng=np.random.default_rng(2))
    assert_same_state(b, out_j)


def test_pad_state_capacity_matches_jax():
    cfg_j, ts_j, cfg_t, ts_t = _both(LOD, 512, 6)
    assert_same_state(tdens.pad_state_capacity(ts_t, 768),
                      jdens.pad_state_capacity(ts_j, 768))
    assert tdens.pad_state_capacity(ts_t, 512) is ts_t
    with pytest.raises(ValueError):
        tdens.pad_state_capacity(ts_t, 256)


def test_clean_stats_matches_jax():
    cfg_j, ts_j, cfg_t, ts_t = _both(FLAT, 1024, 7)
    out_t = tdens.clean_stats(ts_t, cfg_t)
    assert_same_state(out_t, jdens.clean_stats(ts_j, cfg_j))
    assert all(float(a.abs().sum()) == 0 for a in out_t.stats)


@pytest.mark.parametrize("cfg_kw", [FLAT, LOD], ids=["flat", "lod"])
def test_roll_back_matches_jax(cfg_kw):
    cfg_j, ts_j, cfg_t, ts_t = _both(cfg_kw, 1024, 8, street_share=(
        0.3 if cfg_kw is LOD else 0.0))
    n = int(ts_j.n)
    level = np.asarray(ts_j.level)[:n]
    n_base = int((level < 2).sum()) if cfg_kw is LOD else n // 2
    r = np.random.default_rng(3)
    k, F = cfg_kw["n_offsets"], cfg_kw["feat_dim"]
    base = {"anchor": r.normal(size=(n_base, 3)),
            "offset": r.normal(size=(n_base, k, 3)),
            "feat": r.normal(size=(n_base, F)),
            "scaling_log": r.normal(size=(n_base, 6)),
            "rotation": r.normal(size=(n_base, 4))}
    base = {key: v.astype(np.float32) for key, v in base.items()}
    out_t = tdens.roll_back(ts_t, base, cfg_t)
    assert_same_state(out_t, jdens.roll_back(ts_j, base, cfg_j))
    assert out_t.params.anchor.is_leaf and out_t.params.anchor.requires_grad
    if cfg_kw is LOD:   # the base rows are the aerial-level ones
        with pytest.raises(ValueError):
            tdens.roll_back(ts_t, {key: v[:-1] for key, v in base.items()},
                            cfg_t)


@pytest.mark.parametrize("dist2level", ["floor", "round", "ceil",
                                        "progressive"])
def test_weed_out_mask_matches_jax(dist2level):
    cfg = dict(LOD, dist2level=dist2level)
    r = np.random.default_rng(4)
    pos = r.uniform(-3, 3, (400, 3)).astype(np.float32)
    levels = r.integers(0, 4, 400).astype(np.int32)
    cams = np.concatenate([r.uniform(-2, 2, (20, 3)),
                           r.uniform(0.5, 2, (20, 1))], axis=1)
    got = weed_out_mask(ModelConfig(**cfg), pos, levels, cams, 0.25)
    want = j_weed_out_mask(JConfig(**cfg), pos, levels, cams, 0.25)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    assert weed_out_mask(ModelConfig(**cfg), pos, levels, cams, 0.0).all()


def test_train_densify_train():
    """The port trains, densifies and trains on: 12 steps of the flat
    model at 32x32 through K1 and K2's plain versions, a grow+prune epoch
    (statistics gates opened for 12 steps), then 5 more steps at the new
    table: loss finite, the Adam moments follow the rows, the gradients
    reach the new rows, and the state densified is left as it was."""
    from horizongs_tpu_torch.data.synthetic import (
        orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.models.anchors import (
        init_anchor_state_from_points)
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.render import count_render_instances, render
    from horizongs_tpu_torch.train.step import (
        build_train_step, camera_tensors, init_train_state)
    W = H = 32
    cfg = ModelConfig(name="GaussianModel", feat_dim=8, n_offsets=4,
                      view_dim=3, render_mode="RGB", voxel_size=0.1,
                      update_depth=2, update_init_factor=4,
                      update_hierachy_factor=4)
    opt = make_optim(update_interval=10, success_threshold=0.5,
                     densify_grad_threshold=1e-6, min_opacity=0.2,
                     start_stat=0)
    pts = random_gaussians(40, seed=0, extent=0.7)["means"]
    state = init_anchor_state_from_points(cfg, pts, capacity=128,
                                          device="cpu")
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(state.capacity) < state.n)[:, None]
    state = state._replace(
        feat=torch.randn(state.feat.shape, generator=gen) * live,
        offset=torch.randn(state.offset.shape, generator=gen)
        * live[:, :, None])
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=gen, device="cpu")
    cam = orbit_cameras(1, radius=3.5, height_z=-1.0, width=W, height=H,
                        device="cpu")[0]
    with torch.no_grad():
        target = render(cam, cfg, mlps, state._replace(
            feat=torch.randn(state.feat.shape, generator=gen) * live),
            torch.zeros(3), rasterizer="dense")["render"]
    ct = camera_tensors(cam, image=target, do_stats=True)
    ts = init_train_state(state, mlps)
    step = build_train_step(cfg, opt, H, W, add_prefilter=False)
    for it in range(1, 13):
        ts, m = step(ts, ct, it)
    report = {}
    # a deep copy: on the CPU the arrays share the tensors' memory
    before = copy.deepcopy(train_state_to_numpy(ts))
    ts2 = tdens.run_densify(cfg, opt, ts, 12, rng=np.random.default_rng(0),
                            report=report)
    added, removed = report["added"], report["pruned"]
    assert added > 0 and removed > 0
    for g in tdens.TABLES:
        assert ts2.opt.mu[g][0].shape == getattr(ts2.params, g).shape
        assert float(ts2.opt.mu[g][0][ts2.n - added:].abs().sum()) == 0
    cap = suggest_instance_cap(count_render_instances(
        cam, cfg, ts2.params.mlps, ts2.anchor_state(), add_prefilter=False))
    step2 = build_train_step(cfg, opt, H, W, add_prefilter=False,
                             instance_cap=cap)
    losses = []
    for it in range(13, 18):
        ts2, m = step2(ts2, ct, it)
        losses.append(float(m["loss"]))
        assert int(m["n_dropped"]) == 0
    assert np.isfinite(losses).all()
    assert ts2.opt.t == ts.opt.t + 5
    new_rows = slice(ts2.n - added, ts2.n)
    assert float(ts2.opt.nu["feat"][0][new_rows].abs().sum()) > 0
    after = train_state_to_numpy(ts)

    def leaves(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    want = dict(leaves(before))
    for name, v in leaves(after):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[name]),
                                      err_msg=name)
