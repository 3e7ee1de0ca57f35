"""Port parity, the mesh's scaling tool on the CPU:
`horizongs_tpu_torch/tools/bench_scaling.py` against the JAX package's
`tools/bench_scaling.py` on the same model (the JAX tool's own `_scene` at
a small size, carried across by `convert.train_state_from_numpy`), its
helpers at the kernels' 32x32 tiles: the per-view tile spans, the crop
counts against `count_render_instances`, the band-times fit, the batch
simulation, the imbalance counts and the N-card projection; then the
sweep (two gloo ranks) and the 1x1 overhead end to end with
`--device cpu`, and the command line."""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.convert import train_state_from_numpy
from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.render import count_render_instances
from horizongs_tpu_torch.tools import bench_scaling as pbs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools import bench_scaling as jbs  # noqa: E402

W = H = 64
TILE = 32
N_POINTS = 300
VIEWS = 3


def _port_cams(cams):
    return [Camera(viewmat=torch.from_numpy(np.array(c.viewmat)),
                   K=torch.from_numpy(np.array(c.K)), width=c.width,
                   height=c.height,
                   cam_center=torch.from_numpy(np.array(c.cam_center)),
                   uid=int(c.uid)) for c in cams]


@pytest.fixture(scope="module")
def model():
    """The JAX tool's flagship at a small size and its port copy:
    {"jax": (cfg, TrainState, cams), "port": (cfg, TrainState, cams)}."""
    jcfg, jts, jcams = jbs._scene(W, H, N_POINTS, 0, 1, 1)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pcfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                          if k in fields})
    pts = train_state_from_numpy(jax.tree.map(np.asarray, jts),
                                 device="cpu")
    return {"jax": (jcfg, jts, jcams), "port": (pcfg, pts, _port_cams(jcams))}


@pytest.fixture
def same_model(model, monkeypatch):
    """Both tools' `_scene` patched to return the fixture's model."""
    orig = pbs._scene

    def port_scene(width, height, n_points, capacity, n_cams, model_axis,
                   device, model_=None):
        return orig(width, height, n_points, capacity, n_cams, model_axis,
                    device, model=model["port"])
    monkeypatch.setattr(jbs, "_scene", lambda *a, **k: model["jax"])
    monkeypatch.setattr(pbs, "_scene", port_scene)
    return model


def _street_cams():
    """The band-times and imbalance views of both packages: equal
    matrices."""
    from horizongs_tpu.data.synthetic import orbit_cameras as j_orbit
    from horizongs_tpu_torch.data.synthetic import orbit_cameras as p_orbit
    jc = j_orbit(VIEWS, radius=2.0, height_z=-0.15, width=W, height=H)
    pc = p_orbit(VIEWS, radius=2.0, height_z=-0.15, width=W, height=H,
                 device="cpu")
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(np.asarray(a.viewmat), b.viewmat)
        np.testing.assert_array_equal(np.asarray(a.K), b.K)
    return jc, pc


def _edge_distance(cfg, ts, cam):
    """Each gaussian's distance, in tiles, from its box's nearest edge to a
    tile boundary (the port's projection)."""
    from horizongs_tpu_torch.models.anchors import (
        anchor_lod_mask, decode_neural_gaussians)
    from horizongs_tpu_torch.ops.binning import ellipse_extents
    from horizongs_tpu_torch.ops.raster_fields import pack_fields_3dgs
    astate = ts.anchor_state()
    with torch.no_grad():
        mask, smooth = anchor_lod_mask(cfg, astate, cam.cam_center, 1.0)
        dec = decode_neural_gaussians(cfg, ts.params.mlps, astate,
                                      cam.cam_center, mask, smooth)
        f, _, _ = pack_fields_3dgs(dec.means, dec.quats, dec.scales,
                                   dec.opacities, dec.colors, cam.viewmat,
                                   cam.K, W, H)
        rx, ry, _ = ellipse_extents(f[:, 2:5], f[:, 5])
        e = torch.stack([(f[:, 0] - rx), (f[:, 0] + rx), (f[:, 1] - ry),
                         (f[:, 1] + ry)], 1) / TILE
    return (e - torch.round(e)).abs().min(1).values.numpy()


def test_flagship_view_spans_match_the_jax_tool(model):
    """The integer spans of every gaussian in each street view equal the
    JAX tool's; a gaussian whose box edge an ulp of the projection moves
    across a tile boundary may differ, and the test names each such one."""
    from horizongs_tpu.train.optim import mlps_from_params
    jcfg, jts, _ = model["jax"]
    pcfg, pts, _ = model["port"]
    jc, pc = _street_cams()
    want = jbs.flagship_view_spans(jcfg, mlps_from_params(jts.params),
                                   jts.anchor_state(), jc, W, H, TILE, TILE)
    got = pbs.flagship_view_spans(pcfg, pts.params.mlps, pts.anchor_state(),
                                  pc, W, H, TILE, TILE)
    named = []
    for v, (g, w) in enumerate(zip(got, want)):
        y0, y1, wspan = g
        jy0, jy1, jw = (np.asarray(x) for x in w)
        valid = (wspan > 0) | (jw > 0)
        assert valid.sum() > 100
        diff = (wspan != jw) | (valid & ((y0 != jy0) | (y1 != jy1)))
        if diff.any():
            near = _edge_distance(pcfg, pts, pc[v])[diff]
            named += [(v, int(i)) for i in np.flatnonzero(diff)]
            assert (near < 1e-4).all(), (v, np.flatnonzero(diff), near)
    assert len(named) <= 4, named


def test_crop_counts_against_count_render_instances(model):
    """The analytic whole-view count is within 5% of the port's
    `count_render_instances`, the two halves sum to between the whole and
    twice it (splats on the boundary go to both bands), and the port's
    `crop_counts` is the JAX tool's on the same spans."""
    pcfg, pts, _ = model["port"]
    _, pc = _street_cams()
    spans = pbs.flagship_view_spans(pcfg, pts.params.mlps,
                                    pts.anchor_state(), pc, W, H, TILE, TILE)
    rows = H // TILE
    for v, c in enumerate(pc):
        ana = pbs.crop_counts(spans[v], 0, rows)
        ref = count_render_instances(c, pcfg, pts.params.mlps,
                                     pts.anchor_state(), add_prefilter=False)
        assert ref > 0
        assert abs(ana - ref) <= max(0.05 * ref, 4), (ana, ref)
        halves = (pbs.crop_counts(spans[v], 0, rows // 2)
                  + pbs.crop_counts(spans[v], rows // 2, rows))
        assert ana <= halves <= 2 * ana
        for a, b in ((0, rows), (0, 1), (1, rows), (1, 1)):
            assert pbs.crop_counts(spans[v], a, b) == \
                jbs.crop_counts(spans[v], a, b)


def _band_samples(seed):
    rng = np.random.default_rng(seed)
    V = 4
    samples = [(17, float(rng.uniform(1e4, 3e4)), float(rng.uniform(20, 30)))
               for _ in range(V)]
    bands = {}
    for n_m in (2, 4, 8):
        ent = {"instance_cap": 1024}
        for name in ("uniform", "balanced"):
            rows = rng.integers(1, 9, size=n_m).tolist()
            t = rng.uniform(5, 25, size=(V, n_m))
            t[:, -1] = 0.0 if name == "uniform" and n_m == 8 else t[:, -1]
            ent[name] = {"rows": rows, "step_ms": t.round(3).tolist()}
            for v in range(V):
                for b in range(n_m):
                    if t[v, b] > 0:
                        samples.append((rows[b], float(rng.uniform(1e3, 2e4)),
                                        float(t[v, b])))
        bands[str(n_m)] = ent
    tv = np.asarray([s[2] for s in samples[:V]])
    full = [int(s[1]) for s in samples[:V]]
    return samples, bands, tv, full


@pytest.mark.parametrize("seed", [0, 1])
def test_band_times_postprocess_matches_the_jax_tool(seed):
    samples, bands, tv, full = _band_samples(seed)
    fit_p, out_p = pbs.band_times_postprocess(samples, copy.deepcopy(bands),
                                              tv, full)
    fit_j, out_j = jbs.band_times_postprocess(samples, copy.deepcopy(bands),
                                              tv, full)
    assert fit_p.keys() == fit_j.keys()
    for k in fit_j:
        np.testing.assert_allclose(fit_p[k], fit_j[k], rtol=1e-12)
    assert out_p.keys() == out_j.keys()
    for n_m, ent in out_j.items():
        for name in ("uniform", "balanced"):
            for k in ("static_step_ms", "time_worst_over_mean_per_view",
                      "time_worst_over_mean_max"):
                np.testing.assert_allclose(out_p[n_m][name][k],
                                           ent[name][k], rtol=1e-12)


@pytest.mark.parametrize("policy", ["random", "dealt"])
@pytest.mark.parametrize("n_d", [1, 2, 4, 8])
def test_simulate_batches_match_the_jax_tool(policy, n_d):
    costs = np.random.default_rng(3).uniform(1e4, 5e4, size=6)
    assert pbs._simulate_batches(costs, n_d, policy, epochs=40) == \
        jbs._simulate_batches(costs, n_d, policy, epochs=40)


def _args(**kw):
    a = pbs._parser().parse_args(["--device", "cpu", "--width", str(W),
                                  "--height", str(H), "--n_points",
                                  str(N_POINTS), "--views", str(VIEWS)])
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def test_run_imbalance_matches_the_jax_tool(same_model):
    """Per-view instances, per-band record loads and balanced bounds equal
    the JAX tool's on the same model and views."""
    args = _args()
    want = jbs.run_imbalance(args)
    got = pbs.run_imbalance(args, torch.device("cpu"))
    assert got["card"] == "cpu"
    assert got["dp_view_imbalance"] == want["dp_view_imbalance"]
    assert got["band_imbalance"].keys() == want["band_imbalance"].keys()
    for n_m, ent in want["band_imbalance"].items():
        for k in ("per_view_band_loads", "balanced_bounds",
                  "worst_over_mean_max", "balanced_worst_over_mean_max"):
            assert got["band_imbalance"][n_m][k] == ent[k], (n_m, k)
    assert got["n_anchors"] == want["n_anchors"]


def _prior(seed, V=6):
    """A synthetic band-times and overhead record at W x H."""
    rng = np.random.default_rng(seed)
    bt = {"width": W, "height": H, "per_view_1080p": {
        "step_ms": rng.uniform(20, 35, V).round(3).tolist(),
        "instances": rng.integers(20000, 60000, V).tolist()}, "bands": {}}
    for n_m in (2, 4, 8):
        bt["bands"][str(n_m)] = {
            name: {"static_step_ms": rng.uniform(5, 30, (V, n_m)).round(3)
                   .tolist()} for name in ("uniform", "balanced")}
    return bt, {"band_overhead_ratio": float(rng.uniform(1.0, 1.2))}


@pytest.mark.parametrize("n", [4, 8])
def test_run_projection_matches_the_jax_tool(same_model, monkeypatch, n):
    """Every mesh row equals the JAX tool's within rtol 1e-9 on a synthetic
    prior, the port's link rate set to the JAX tool's ICI rate."""
    bt, ovh = _prior(n)
    monkeypatch.setattr(pbs, "NVLINK_BW", jbs.ICI_BW)
    args = _args(project=n)
    want = jbs.run_projection(args, {"tpu_1x1_overhead": ovh,
                                     "band_time_skew": bt})
    got = pbs.run_projection(args, {"card_1x1_overhead": ovh,
                                    "band_time_skew": bt},
                             torch.device("cpu"))
    assert [r["mesh"] for r in got["meshes"]] == \
        [r["mesh"] for r in want["meshes"]]
    for g, w in zip(got["meshes"], want["meshes"]):
        assert g.keys() == w.keys()
        assert g["band_cap"] == w["band_cap"]
        for k, v in w.items():
            if k != "mesh":
                np.testing.assert_allclose(g[k], v, rtol=1e-9, err_msg=k)
    assert got["best_mesh"] == want["best_mesh"]
    assert got["n_cards"] == n
    b = got["basis"]
    assert b["table_grad_bytes"] == want["basis"]["table_grad_bytes"]
    assert b["mlp_grad_bytes"] == want["basis"]["mlp_grad_bytes"]
    assert b["record_bytes"] == 44 and b["halo_px"] == 5
    assert b["link_bw_bytes_per_s_one_way"] == jbs.ICI_BW


def test_projection_needs_the_measured_records(same_model):
    with pytest.raises(SystemExit, match="card_1x1_overhead"):
        pbs.run_projection(_args(project=4), {}, torch.device("cpu"))
    with pytest.raises(SystemExit, match="band_time_skew"):
        pbs.run_projection(_args(project=4), {"card_1x1_overhead": {
            "band_overhead_ratio": 1.0}}, torch.device("cpu"))


SMALL = ["--device", "cpu", "--n_points", "40"]


def test_sweep_on_cpu(tmp_path):
    """`--devices 1,2` with `--device cpu`: a row for one rank and one for
    two gloo ranks (1x2 bands and the 2x1 pure-DP control on the same
    ranks), nothing dropped, the shared-card efficiency, and the other
    modes' keys of the out file carried over."""
    out = tmp_path / "scaling.json"
    out.write_text(json.dumps({"card_1x1_overhead": {"x": 1},
                               "projected_efficiency_4card": {"y": 2},
                               "other": 3}))
    assert pbs.main([*SMALL, "--width", "48", "--height", "48",
                     "--devices", "1,2", "--iters", "2", "--out",
                     str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["card_1x1_overhead"] == {"x": 1}
    assert rec["projected_efficiency_4card"] == {"y": 2}
    assert "other" not in rec
    assert rec["platform"] == "cpu" and rec["card"] == "cpu"
    assert rec["shared_card"] is True and rec["rasterizer"] == "cuda"
    r1, r2 = rec["results"]
    assert (r1["devices"], r1["mesh"], r2["devices"], r2["mesh"]) == \
        (1, "1x1", 2, "1x2")
    assert r1["backend"] == r2["backend"] == "gloo"
    assert "pure_dp" not in r1 and r1["efficiency"] == 1.0
    assert r2["pure_dp"]["mesh"] == "2x1"
    assert r2["band_cap"] is not None and r2["pure_dp"]["band_cap"] is None
    assert r2["efficiency"] == r2["efficiency_vs_pure_dp"] == \
        r2["rays_per_sec"] / r2["rays_per_sec_pure_dp"]
    for part in (r1, r2, r2["pure_dp"]):
        assert part["n_dropped"] == 0 and part["margin"] == 1.5
        assert part["step_ms"] > 0 and np.isfinite(part["step_ms"])
        # the plain versions run on the CPU: no kernel is counted
        assert all(x == [0, 0] for x in part["launches_per_rank"])
        assert all(s == 1 + 2 for s in part["steps_run_per_rank"])
    assert len(r2["step_ms_p50_per_rank"]) == 2
    assert r1["rays_per_sec"] == pytest.approx(48 * 48 / (r1["step_ms"]
                                                          / 1e3))


def test_tpu_overhead_on_cpu(tmp_path):
    out = tmp_path / "scaling.json"
    assert pbs.main([*SMALL, "--width", "32", "--height", "32",
                     "--tpu_overhead", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec) == {"card_1x1_overhead"}
    o = rec["card_1x1_overhead"]
    assert o["card"] == "cpu" and (o["width"], o["height"]) == (32, 32)
    assert np.isfinite(o["band_overhead_ratio"])
    assert o["band_overhead_ratio"] == o["band_step_ms"] / o["plain_step_ms"]
    assert o["iters"] == 12
    for k in ("plain", "band"):
        assert len(o["rounds_ms"][k]) == 3
        assert o["steps_run"][k] == 3 * (1 + 12)
        assert o["launches"][k] == [0, 0] and o["n_dropped"][k] == 0


JAX_COMMAND_LINES = [
    [], ["--devices", "1,2,4,8", "--out", "SCALING.json"],
    ["--tpu_overhead", "--out", "SCALING.json"],
    ["--band_times", "--views", "6"], ["--project", "8"], ["--imbalance"],
    ["--width", "256", "--height", "128", "--n_points", "5000",
     "--capacity", "8192", "--model_axis", "4", "--warmup", "2",
     "--iters", "8"],
    *[["--rasterizer", r] for r in ("tiled", "pallas", "auto",
                                    "pallas_interpret")]]


@pytest.mark.parametrize("argv", JAX_COMMAND_LINES,
                         ids=[" ".join(a) or "defaults"
                              for a in JAX_COMMAND_LINES])
def test_every_jax_command_line_parses(argv):
    args = pbs._parser().parse_args(argv)
    assert args.device is None and args.worker is None
    if not argv:
        assert args.out == str(ROOT / "build" / "scaling.json")
        assert (args.devices, args.width, args.height, args.n_points,
                args.model_axis, args.views) == ("1,2,4,8", 512, 512, 20000,
                                                 2, 6)


def test_without_a_card_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbs.main(["--imbalance", "--out", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()
