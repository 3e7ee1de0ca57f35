"""The port's mesh path on the CPU: the band exchange, the field-level
compositing API and the sharded step (`parallel/step.py`), in gloo ranks
spawned as processes (`torch_mesh_worker.py`, a `file://` store, one
torch thread each), against the JAX package's sharded step on the
conftest's virtual 8-device mesh and against the port's own single-device
step and replicated fallback.

The JAX step runs its Pallas kernels in interpret mode (so its tile
shapes and band boundaries are the port's), its SSIM blur as a float32
product (`f32_blur`) and, for 2DGS, the gradient-safe `depth_to_normals`
(the reference's has a NaN gradient on the border, ROADMAP §3; its band
step imports it by name, so it is swapped there too). Both sides start
from one state (the JAX package's, carried across by `convert.py`) and
the JAX targets. Tolerances (ROADMAP "Tolerances"): loss rtol 1e-5;
gradients per tensor within 2e-4 x its max |grad| (the JAX gradients read
from Adam's first moment, mu = (1 - b1) g); the state after the step
atol 1e-5 where |grad| > 1e-3 x the tensor's max (Adam's first step is
+-lr x sign(g), and a near-zero gradient may take the other sign when it
is summed in another order); statistics 2e-4 x max.
"""
import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.convert import train_state_from_numpy
from horizongs_tpu_torch.data.synthetic import lookat_camera, random_gaussians
from horizongs_tpu_torch.io.checkpoints import save_train_checkpoint
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.ops.reference import render_dense_3dgs
from horizongs_tpu_torch.parallel import tile_exchange as tx
from horizongs_tpu_torch.parallel.step import count_band_instances
from horizongs_tpu_torch.train import step as tstep
from test_torch_losses import f32_blur  # noqa: F401  (fixture)
from test_torch_raster2d import safe_depth_normals  # noqa: F401  (fixture)
from test_torch_train import (
    FLAT,
    SURFEL_LOSSES,
    _j_groups,
    _j_train_state,
    _leaves,
    _np,
    _targets,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
W = H = 48
OKW = dict(iterations=2000, start_stat=0, feature_lr=0.03,
           mlp_color_lr_init=0.02, mlp_opacity_lr_init=0.01,
           lambda_dreg=0.01)
FLAT_ED = dict(FLAT, render_mode="RGB+ED")


def run_mesh(case, data, model, tmp_path, spec, state=None, timeout=300):
    """Run `case` of torch_mesh_worker.py in data x model gloo ranks;
    returns each rank's result, in rank order."""
    d = tmp_path / f"{case}_{data}x{model}_{uuid.uuid4().hex[:8]}"
    d.mkdir()
    if state is not None:
        save_train_checkpoint(str(d / "state.npz"), state, 0)
    torch.save(dict(spec, data=data, model=model), d / "spec.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    world = data * model
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _cam_dicts(cts):
    return [ct._asdict() for ct in cts]


def _scene(cfg_kw, n_cams=4, noise=0.3, capacity=256):
    """The JAX state (for the JAX side) and its port copy, the port's
    cameras and the JAX-rendered targets (`test_torch_train._targets`)."""
    from horizongs_tpu.models import ModelConfig as JConfig
    cams, images, pts = _targets(n_cams)
    ts_j = _j_train_state(JConfig(**cfg_kw), pts, capacity=capacity,
                          noise=noise)
    return ts_j, train_state_from_numpy(_np(ts_j), device="cpu"), cams, images


def _full_grads(results, model):
    """The ranks' reduced gradients -> the whole table's (the tables'
    rows concatenated over "model" from data index 0; the decoders'
    from rank 0, which every rank must hold equal)."""
    out = {}
    for k, v in results[0]["grads"].items():
        if k in ("anchor", "offset", "feat", "scaling_log"):
            out[k] = [torch.cat([results[m]["grads"][k][0]
                                 for m in range(model)])]
        else:
            for r in results[1:]:
                for a, b in zip(v, r["grads"][k]):
                    assert torch.equal(a, b), k
            out[k] = v
    return out


def _grad_leaves(grads):
    return {f"{k}.{i}": g.numpy() for k, v in grads.items()
            for i, g in enumerate(v)}


def _assert_grads_close(got, want, what):
    assert set(got) == set(want)
    for k in want:
        scale = np.abs(want[k]).max()
        if scale == 0:
            assert np.abs(got[k]).max() == 0, f"{what} {k}"
            continue
        err = np.abs(got[k] - want[k]).max()
        assert err <= 2e-4 * scale, f"{what} {k}: {err} > 2e-4 x {scale}"


def _single(cfg_kw, ts, ct, it, okw=OKW, prefilter=False):
    """The port's single-device step: (loss, grads, new state numpy)."""
    from horizongs_tpu_torch.convert import (
        train_state_to_device, train_state_to_numpy)
    step = tstep.build_train_step(ModelConfig(**cfg_kw), make_optim(**okw),
                                  ct.image.shape[0], ct.image.shape[1],
                                  add_prefilter=prefilter)
    ts = train_state_to_device(ts, "cpu")
    loss, aux, pkg, grads, pg = step.value_and_grad(ts, ct, it)
    new, m = step.update(ts, ct, it, loss, aux, pkg, grads, pg)
    return float(loss), grads, train_state_to_numpy(new), m


def _full_state(results, model):
    """Ranks' `train_state_to_numpy` of their rows -> the whole table's
    tables, moments and statistics (data index 0)."""
    out = {}
    for part in ("params", "mu", "nu"):
        out[part] = {k: np.concatenate([results[m]["state"][part][k]
                                        for m in range(model)])
                     for k in ("anchor", "offset", "feat", "scaling_log")}
    out["stats"] = {k: np.concatenate([results[m]["state"]["stats"][k]
                                       for m in range(model)])
                    for k in results[0]["state"]["stats"]}
    return out


def _step_spec(cfg_kw, cts, it, okw=OKW, **step_kw):
    step_kw.setdefault("add_prefilter", False)
    return {"cfg": cfg_kw, "opt": okw, "H": cts[0].image.shape[0],
            "W": cts[0].image.shape[1], "cams": _cam_dicts(cts),
            "iteration": it, "step": step_kw}


# --- the JAX package's sharded step against the port's ----------------------

def _jax_sharded(cfg_kw, ts_j, cams, images, views, weights, data, model,
                 okw=OKW):
    """The JAX sharded band step (Pallas interpret) on views of the
    targets: (metrics, new state)."""
    import jax
    import jax.numpy as jnp

    from horizongs_tpu.config import make_optim as j_make_optim
    from horizongs_tpu.models import ModelConfig as JConfig
    from horizongs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from horizongs_tpu.parallel.step import (
        build_sharded_train_step as j_build, shard_state as j_shard)
    from horizongs_tpu.train import step as jstep
    cts = [jstep.CameraTensors(
        viewmat=jnp.asarray(cams[v].viewmat.numpy()),
        K=jnp.asarray(cams[v].K.numpy()),
        cam_center=jnp.asarray(cams[v].cam_center.numpy()),
        uid=jnp.int32(0), image=jnp.asarray(images[v]),
        alpha_mask=jnp.ones((H, W, 1)), invdepth=jnp.zeros((H, W, 1)),
        depth_mask=jnp.zeros((H, W, 1)), has_depth=jnp.float32(0),
        do_stats=jnp.float32(1), resolution_scale=jnp.float32(1),
        loss_weight=jnp.float32(w)) for v, w in zip(views, weights)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cts)
    mesh = j_make_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])
    step = j_build(JConfig(**cfg_kw), j_make_optim(**okw), mesh, H, W,
                   add_prefilter=False, shard_tiles=True,
                   rasterizer="pallas_interpret")
    new, m = step(j_shard(ts_j, mesh), batch, 3)
    return m, new


def _port_cts(cams, images, views, weights):
    return [tstep.camera_tensors(cams[v], image=torch.from_numpy(images[v]),
                                 do_stats=True, loss_weight=w)
            for v, w in zip(views, weights)]


@pytest.mark.parametrize("case", ["3dgs_1x2", "2dgs_1x2", "dp_2x1_dup"])
def test_sharded_step_matches_jax(case, tmp_path, f32_blur, monkeypatch):
    import horizongs_tpu.parallel.step as jpstep
    from test_torch_raster2d import jax_depth_to_normals_safe
    cfg_kw, okw = FLAT_ED, OKW
    data, model, views, weights = 1, 2, [3], [1.0]
    if case == "2dgs_1x2":
        cfg_kw, okw = dict(FLAT_ED, gs_attr="2D"), dict(OKW, **SURFEL_LOSSES)
        import horizongs_tpu.ops.reference as jref
        monkeypatch.setattr(jref, "depth_to_normals",
                            jax_depth_to_normals_safe)
        monkeypatch.setattr(jpstep, "depth_to_normals",
                            jax_depth_to_normals_safe)
    elif case == "dp_2x1_dup":
        data, model, views, weights = 2, 1, [3, 3], [0.5, 0.5]
    ts_j, ts_t, cams, images = _scene(cfg_kw)
    m_j, new_j = _jax_sharded(cfg_kw, ts_j, cams, images, views, weights,
                              data, model, okw)
    res = run_mesh("step", data, model, tmp_path,
                   _step_spec(cfg_kw, _port_cts(cams, images, views,
                                                weights), 3, okw), ts_t)
    for r in res:
        np.testing.assert_allclose(r["metrics"]["loss"], float(m_j["loss"]),
                                   rtol=1e-5, atol=1e-7)
        assert r["metrics"]["n_dropped"] == 0
    np.testing.assert_allclose(res[0]["metrics"]["psnr"], float(m_j["psnr"]),
                               rtol=1e-5)
    got = _grad_leaves(_full_grads(res, model))
    mu_j = _leaves(_np(_j_groups(new_j.opt.mu)))
    want = {}
    names = {"mlp_opacity", "mlp_cov", "mlp_color"}
    for k, v in _full_grads(res, model).items():
        if k in names:
            jk = [f"{k}.{l}.{q}" for l in ("l1", "l2") for q in ("w", "b")]
            for i, name in enumerate(jk):
                want[f"{k}.{i}"] = mu_j[name] / 0.1
        elif v:
            want[f"{k}.0"] = mu_j[k] / 0.1
    _assert_grads_close(got, want, case)
    full = _full_state(res, model)
    p_j = _leaves(_np(_j_groups(new_j.params)))
    for k in ("anchor", "offset", "feat", "scaling_log"):
        g = want[f"{k}.0"]
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(full["params"][k][big], p_j[k][big],
                                   atol=1e-5, err_msg=k)
    s_j = _np(new_j.stats)
    for f in tstep.DensifyStats._fields:
        w_ = np.asarray(getattr(s_j, f))
        np.testing.assert_allclose(full["stats"][f], w_, rtol=0,
                                   atol=2e-4 * max(np.abs(w_).max(), 1e-30),
                                   err_msg=f)


# --- the port's sharded step against its own single-device step -------------

@pytest.mark.parametrize("gs", ["3D", "2D"])
def test_band_step_matches_single_device(gs, tmp_path):
    cfg_kw = dict(FLAT_ED, gs_attr=gs)
    okw = dict(OKW, **(SURFEL_LOSSES if gs == "2D" else {}))
    ts_j, ts_t, cams, images = _scene(cfg_kw)
    cts = _port_cts(cams, images, [1], [1.0])
    loss, grads, new, m1 = _single(cfg_kw, ts_t, cts[0], 3, okw)
    res = run_mesh("step", 1, 2, tmp_path, _step_spec(cfg_kw, cts, 3, okw),
                   ts_t)
    for r in res:
        np.testing.assert_allclose(r["metrics"]["loss"], loss, rtol=1e-5)
    want = _grad_leaves(grads)
    _assert_grads_close(_grad_leaves(_full_grads(res, 2)), want, gs)
    full = _full_state(res, 2)
    for k in ("anchor", "offset", "feat", "scaling_log"):
        g = want[f"{k}.0"]
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(full["params"][k][big],
                                   new["params"][k][big], atol=1e-5,
                                   err_msg=k)
    for f in tstep.DensifyStats._fields:
        w_ = new["stats"][f]
        np.testing.assert_allclose(full["stats"][f], w_, rtol=0,
                                   atol=2e-4 * max(np.abs(w_).max(), 1e-30),
                                   err_msg=f)
    assert res[0]["n_records"] == res[1]["n_records"] > 0
    # the trainer's per-band capacity counts what each band bins
    counted = count_band_instances(cams[1], ModelConfig(**cfg_kw),
                                   ts_t.params.mlps, ts_t.anchor_state(), 2,
                                   add_prefilter=False)
    assert [r["n_instances"] for r in res] == counted


def test_band_step_matches_replicated_fallback(tmp_path):
    """The band path against the all_gather fallback on one 1x2 step."""
    ts_j, ts_t, cams, images = _scene(FLAT_ED)
    cts = _port_cts(cams, images, [2], [1.0])
    band = run_mesh("step", 1, 2, tmp_path, _step_spec(FLAT_ED, cts, 3),
                    ts_t)
    repl = run_mesh("step", 1, 2, tmp_path,
                    _step_spec(FLAT_ED, cts, 3, shard_tiles=False), ts_t)
    for b, r in zip(band, repl):
        np.testing.assert_allclose(b["metrics"]["loss"],
                                   r["metrics"]["loss"], rtol=1e-5)
    _assert_grads_close(_grad_leaves(_full_grads(band, 2)),
                        _grad_leaves(_full_grads(repl, 2)), "band vs repl")
    for b, r in zip(band, repl):
        pb, pr = b["probe_grad"].numpy(), r["probe_grad"].numpy()
        assert np.abs(pb - pr).max() <= 2e-4 * np.abs(pr).max()


def test_dp_gradient_is_the_weighted_mean(tmp_path):
    """2x1: two views, the gradient the mean of their single-device
    gradients; the loss their mean."""
    ts_j, ts_t, cams, images = _scene(FLAT_ED)
    cts = _port_cts(cams, images, [0, 2], [1.0, 1.0])
    singles = [_single(FLAT_ED, ts_t, ct, 3) for ct in cts]
    res = run_mesh("step", 2, 1, tmp_path, _step_spec(FLAT_ED, cts, 3),
                   ts_t)
    want = {k: (a + b) / 2 for (k, a), b in zip(
        _grad_leaves(singles[0][1]).items(),
        _grad_leaves(singles[1][1]).values())}
    _assert_grads_close(_grad_leaves(_full_grads(res, 1)), want, "dp")
    for r in res:
        np.testing.assert_allclose(r["metrics"]["loss"],
                                   (singles[0][0] + singles[1][0]) / 2,
                                   rtol=1e-5)


def _view_scene(Wo, Ho, n, seed, scale_range, capacity=256, below=False):
    """One lookat view of a seeded cloud (its dense render the target) and
    a state on the cloud: (state, camera tensors, camera)."""
    from horizongs_tpu.models import ModelConfig as JConfig
    g = random_gaussians(n, seed=seed, extent=0.8, scale_range=scale_range)
    if below:                               # the cloud below the middle
        g["means"][:, 1] = np.abs(g["means"][:, 1]) + 0.1
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    cam = lookat_camera(width=Wo, height=Ho, eye=(0, 0, -3.2), device="cpu")
    img = render_dense_3dgs(gt["means"], gt["quats"], gt["scales"],
                            gt["opacities"], gt["colors"], cam.viewmat,
                            cam.K, Wo, Ho, torch.zeros(3))[0]
    ts_j = _j_train_state(JConfig(**FLAT_ED), g["means"], capacity=capacity,
                          noise=0.3)
    ts_t = train_state_from_numpy(_np(ts_j), device="cpu")
    return ts_t, tstep.camera_tensors(cam, image=img, do_stats=True), cam


def test_three_real_bands_odd_height(tmp_path):
    """1x3 at 64x75: three real bands of one 32-px tile row, the middle
    one with real halo rows on both sides, the last with 11 real rows
    and 21 past the image bottom."""
    ts_t, ct, cam = _view_scene(64, 75, 40, 2, (0.1, 0.25), capacity=258)
    loss, grads, new, _ = _single(FLAT_ED, ts_t, ct, 3)
    res = run_mesh("step", 1, 3, tmp_path, _step_spec(FLAT_ED, [ct], 3),
                   ts_t)
    assert all(r["metrics"]["n_dropped"] == 0 for r in res)
    assert [r["n_instances"] for r in res] == count_band_instances(
        cam, ModelConfig(**FLAT_ED), ts_t.params.mlps, ts_t.anchor_state(),
        3, add_prefilter=False)
    np.testing.assert_allclose(res[1]["metrics"]["loss"], loss, rtol=1e-5)
    _assert_grads_close(_grad_leaves(_full_grads(res, 3)),
                        _grad_leaves(grads), "three bands")


def test_balanced_bounds_match_single_device(tmp_path):
    """1x2 at 64x96 (3 tile rows) with the bounds `suggest_band_bounds`
    cuts from the view's tile-row loads, which are not the uniform ones."""
    from horizongs_tpu_torch.parallel.step import count_view_row_loads
    Wo, Ho = 64, 96
    ts_t, ct, cam = _view_scene(Wo, Ho, 60, 5, (0.05, 0.15), below=True)
    loads = count_view_row_loads(cam, ModelConfig(**FLAT_ED),
                                 ts_t.params.mlps, ts_t.anchor_state(),
                                 add_prefilter=False)
    bounds = tx.suggest_band_bounds(loads.numpy(), 2)
    assert bounds != tx.band_layout(Ho, Wo, 2, 32).bounds, bounds
    loss, grads, _, _ = _single(FLAT_ED, ts_t, ct, 3)
    res = run_mesh("step", 1, 2, tmp_path,
                   _step_spec(FLAT_ED, [ct], 3, band_bounds=bounds), ts_t)
    np.testing.assert_allclose(res[0]["metrics"]["loss"], loss, rtol=1e-5)
    _assert_grads_close(_grad_leaves(_full_grads(res, 2)),
                        _grad_leaves(grads), "balanced")


def test_overflow_counted_never_silent(tmp_path):
    """band_cap=1 drops records and counts them as exchange drops; a
    starved instance_cap (G = 128, the least) counts instance drops and
    no exchange drop."""
    ts_t, ct, _ = _view_scene(128, 128, 80, 3, (0.1, 0.3))
    cts = [ct]
    res = run_mesh("step", 1, 2, tmp_path,
                   _step_spec(FLAT_ED, cts, 3, band_cap=1), ts_t)
    for r in res:
        m = r["metrics"]
        assert m["n_dropped_exchange"] > 0
        assert m["n_dropped"] >= m["n_dropped_exchange"]
        assert np.isfinite(m["loss"])
    res = run_mesh("step", 1, 2, tmp_path,
                   _step_spec(FLAT_ED, cts, 3, instance_cap=128), ts_t)
    for r in res:
        assert r["metrics"]["n_dropped_instances"] > 0
        assert r["metrics"]["n_dropped_exchange"] == 0


# --- per-rank pieces, in this process ---------------------------------------

def _routing_case(K=300, seed=0):
    rng = np.random.default_rng(seed)
    my = rng.uniform(-20, 150, K).astype(np.float32)
    ry = rng.uniform(0, 30, K).astype(np.float32)
    valid = rng.uniform(size=K) > 0.2
    rec = rng.normal(size=(K, 11)).astype(np.float32)
    return rec, my, ry, valid


@pytest.mark.parametrize("cap", [400, 120, 7])
def test_route_records_matches_jax(cap):
    import jax.numpy as jnp

    from horizongs_tpu.parallel import tile_exchange as jtx
    rec, my, ry, valid = _routing_case()
    for bounds in (None, (0, 1, 3, 5)):
        lj = jtx.band_layout(128, 64, 3, 32, bounds=bounds)
        lt = tx.band_layout(128, 64, 3, 32, bounds=bounds)
        assert tuple(lj) == tuple(lt)
        send_j, drop_j = jtx.route_records(
            jnp.asarray(rec), jnp.asarray(my), jnp.asarray(ry),
            jnp.asarray(valid), lj, min(cap, rec.shape[0]), halo_px=5)
        send_t, drop_t = tx.route_records(
            torch.from_numpy(rec), torch.from_numpy(my),
            torch.from_numpy(ry), torch.from_numpy(valid), lt,
            min(cap, rec.shape[0]), halo_px=5)
        np.testing.assert_array_equal(send_t.numpy(), np.asarray(send_j))
        assert int(drop_t) == int(drop_j)
        if cap == 7:
            assert int(drop_t) > 0
    # a cap above the row count pads with empty slots
    send, drop = tx.route_records(torch.from_numpy(rec),
                                  torch.from_numpy(my), torch.from_numpy(ry),
                                  torch.from_numpy(valid), lt, 400)
    assert send.shape == (3 * 400, 11) and int(drop) == 0
    assert not send.reshape(3, 400, 11)[:, 300:].any()


def test_row_loads_and_bounds_match_jax():
    import jax.numpy as jnp

    from horizongs_tpu.parallel import tile_exchange as jtx
    rec, my, ry, valid = _routing_case(seed=1)
    want = jtx.count_tile_row_loads(jnp.asarray(my), jnp.asarray(ry),
                                    jnp.asarray(valid), 5, 32)
    got = tx.count_tile_row_loads(torch.from_numpy(my), torch.from_numpy(ry),
                                  torch.from_numpy(valid), 5, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for loads in ([1, 1, 1, 50, 1, 1], [0, 0, 0, 0], [5, 9, 2, 7, 7, 1, 3],
                  [3], np.asarray(want)):
        for n in (1, 2, 3, 4):
            assert tx.suggest_band_bounds(loads, n) == \
                jtx.suggest_band_bounds(loads, n), (loads, n)
    for n in (0, 1, 7, 100, 12345):
        assert tx.suggest_band_cap(n) == jtx.suggest_band_cap(n)
    lj = jtx.band_layout(128, 64, 3, 32)
    lt = tx.band_layout(128, 64, 3, 32)
    assert int(tx.count_routed_records(
        torch.from_numpy(my), torch.from_numpy(ry), torch.from_numpy(valid),
        lt, 5)) == int(jtx.count_routed_records(
            jnp.asarray(my), jnp.asarray(ry), jnp.asarray(valid), lj, 5))
    with pytest.raises(ValueError):
        tx.band_layout(128, 64, 2, 32, bounds=(0, 1))


def test_exchange_single_band_skips_routing():
    rec, my, ry, valid = _routing_case()
    L = tx.band_layout(128, 64, 1, 32)
    out, drop = tx.exchange_records(torch.from_numpy(rec),
                                    torch.from_numpy(my),
                                    torch.from_numpy(ry),
                                    torch.from_numpy(valid), L, 300)
    np.testing.assert_array_equal(out.numpy(), rec * valid[:, None])
    assert int(drop) == 0


@pytest.mark.parametrize("gs", ["3D", "2D"])
def test_raster_fields_one_band_equals_render(gs):
    """`render(rasterizer="cuda")` and the field-level API at one band
    covering the view give the same image; a band shifted by dy gives
    the view's rows from dy on (2DGS: to rounding; from `row0` on a tile
    row, exactly)."""
    from horizongs_tpu_torch.ops import raster_fields as rf
    from horizongs_tpu_torch.render import decode_view, render
    cfg_kw = dict(FLAT_ED, gs_attr=gs)
    ts_j, ts_t, cams, images = _scene(cfg_kw)
    cfg = ModelConfig(**cfg_kw)
    cam, bg = cams[1], torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        pkg = render(cam, cfg, ts_t.params.mlps, ts_t.anchor_state(), bg,
                     add_prefilter=False)
        dec = decode_view(cam, cfg, ts_t.params.mlps, ts_t.anchor_state(),
                          False)
        args = (dec.means, dec.quats, dec.scales, dec.opacities, dec.colors,
                cam.viewmat, cam.K, W, H)
        if gs == "2D":
            f, radii, depths, _ = rf.pack_fields_2dgs(*args)
            out = rf.composite_fields_2dgs(f, radii, depths, W, H, bg,
                                           cfg.render_mode)
            band = rf.composite_fields_2dgs(rf.shift_band_2dgs(f, 16.0),
                                            radii, depths, W, 32, bg,
                                            cfg.render_mode)
            np.testing.assert_array_equal(out[2].numpy(),
                                          pkg["render_normals"].numpy())
            np.testing.assert_array_equal(out[4].numpy(),
                                          pkg["render_median_depth"].numpy())
            # the band at the view's coordinates from a tile row: the
            # view's rows, bit for bit
            rows = rf.composite_fields_2dgs(f, radii, depths, W, 32, bg,
                                            cfg.render_mode, row0=16)
            for a, b in zip(rows[:5], out[:5]):
                np.testing.assert_array_equal(a.numpy(), b[16:48].numpy())
        else:
            f, radii, _ = rf.pack_fields_3dgs(*args)
            out = rf.composite_fields_3dgs(f, radii, W, H, bg,
                                           cfg.render_mode)
            band = rf.composite_fields_3dgs(rf.shift_band_3dgs(f, 16.0),
                                            radii, W, 32, bg, cfg.render_mode)
    image = torch.cat([pkg["render"], pkg["render_depth"]], -1)
    np.testing.assert_array_equal(out[0].numpy(), image.numpy())
    np.testing.assert_array_equal(out[1].numpy(),
                                  pkg["render_alphas"].numpy())
    assert int(out[-1]["n_dropped"]) == 0
    np.testing.assert_allclose(band[0][:, :, :3].numpy(),
                               image[16:48, :, :3].numpy(), atol=2e-5)
    np.testing.assert_allclose(band[1].numpy(),
                               pkg["render_alphas"][16:48].numpy(),
                               atol=2e-5)

