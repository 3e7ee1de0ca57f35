"""Port parity, the measurement tools T1-T3 on the CPU: the T1 workload
against the JAX tool's own arrays, K1's plain version on it against the
JAX forward kernel (interpret mode), T2's scene against the JAX tool's
instance count, T3's plain versions, and the wrappers' CPU rules (T1 and
T2 "full" take K1's and K2's plain versions; T2's stripped variants and
the timing tools raise). The kernels themselves are held on the card in
`tests/test_torch_cuda.py`.

Then the train CLI's `--wandb` (without the package, and with a stub
module against the JAX CLI's logged keys and steps), and the tools of
the rest of the port on the CPU at small sizes:
`tools/mesh_check`'s calibration against the trainer's,
`profile_band_overhead`, `convergence_check` and `bench_densify`, each
writing its JSON."""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.ops import grid_overhead as go
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.tools import fused_fwd
from horizongs_tpu_torch.tools import profile_bwd_variants as pbv
from horizongs_tpu_torch.tools import profile_grid_overhead as pgo

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NTX, NTY = 4, 3


def _jax_tool_workloads(monkeypatch):
    """The (16, CAP+2G) instance columns and tile starts that the JAX tool
    `tools/experiment_fused_fwd.py` builds for each L at NTX x NTY tiles:
    its `main` run with the kernels and jit swapped for a recorder."""
    spec = importlib.util.spec_from_file_location(
        "experiment_fused_fwd", ROOT / "tools" / "experiment_fused_fwd.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = []

    def record(d, ts, ntx, nty):
        if not seen or seen[-1][0] is not d:
            seen.append((d, ts))
        return jnp.zeros(1), jnp.zeros(1)

    monkeypatch.setattr(tool, "rasterize_fwd", record)
    monkeypatch.setattr(tool, "rasterize_fwd_fused", record)
    monkeypatch.setattr(tool.jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(sys, "argv", ["experiment_fused_fwd", "--iters", "1",
                                      "--n_tiles_x", str(NTX),
                                      "--n_tiles_y", str(NTY)])
    tool.main()
    return [(np.asarray(d), np.asarray(ts)) for d, ts in seen]


def test_t1_workload_matches_the_jax_tool(monkeypatch):
    want = _jax_tool_workloads(monkeypatch)
    got = list(fused_fwd.equal_l_workloads(NTX, NTY))
    assert [L for L, _, _ in got] == list(fused_fwd.SWEEP)
    assert len(want) == len(got)
    for (L, fields, starts), (data, ts) in zip(got, want):
        cap = fields.shape[0]
        assert cap == NTX * NTY * L * raster3d.G
        np.testing.assert_array_equal(fields, data[:10, :cap].T)
        np.testing.assert_array_equal(data[10, :cap], 1.0)   # validity row
        assert not data[11:].any() and not data[:, cap:].any()
        np.testing.assert_array_equal(starts, ts)


@pytest.mark.parametrize("L", [1, 2])
def test_k1_plain_on_the_t1_workload_matches_jax(L):
    """K1's plain version on the equal-L workload against the JAX forward
    kernel in interpret mode: rgb, depth and alpha rows and log T at atol
    1e-4. (i_fin differs by convention: the TPU kernel counts chunk pairs
    from a 128-aligned base.)"""
    from horizongs_tpu.ops.pallas.raster3d import INST_DIM, rasterize_fwd
    _, fields, starts = next(w for w in fused_fwd.equal_l_workloads(
        NTX, NTY, Ls=(1, 2)) if w[0] == L)
    cap = fields.shape[0]
    data = np.zeros((INST_DIM, cap + 2 * raster3d.G), np.float32)
    data[:10, :cap] = fields.T
    data[10, :cap] = 1.0
    acc_j, logT_j = rasterize_fwd(jnp.asarray(data), jnp.asarray(starts),
                                  NTX, NTY, interpret=True)
    args = fused_fwd.workload_args(fields, starts, NTX, NTY, "cpu")
    acc, logT, n_contrib = raster3d.rasterize_fwd_plain(*args)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j)[:, 6:11],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(logT[:, 0].numpy(), np.asarray(logT_j)[:, 0],
                               atol=1e-4, rtol=0)
    assert float(acc[:, 4].max()) > 0.01         # the gaussians are seen
    assert (n_contrib == L * raster3d.G).all()   # opacity 0.005: no stop


def test_t1_cpu_path_and_tool():
    _, fields, starts = next(fused_fwd.equal_l_workloads(NTX, NTY, Ls=(1,)))
    args = fused_fwd.workload_args(fields, starts, NTX, NTY, "cpu")
    ref = raster3d.rasterize_fwd_plain(*args)
    for s in raster3d.SCHEDULES:
        assert fused_fwd.mismatches(
            raster3d.rasterize_fwd_persistent(*args, schedule=s), ref) == 0
    with pytest.raises(ValueError):
        raster3d.rasterize_fwd_persistent(*args, schedule="hardware")
    with pytest.raises(ValueError):
        raster3d.persistent_grid(NTX * NTY, "hardware", "cuda")
    assert fused_fwd.check_schedules(args) == {"static": [0, 0],
                                               "dynamic": [0, 0]}
    assert fused_fwd.main(["--device", "cpu", "--n_tiles_x", "2",
                           "--n_tiles_y", "1"]) == 0


def test_t2_scene_matches_the_jax_tool():
    """T2's scene at 3000 gaussians and 256x160: the JAX tool's projection,
    cull and binning (`tools/profile_bwd_variants.py:207-221`) enumerate
    as many instances, and the cotangents are d_acc = 1, d_logT = 0."""
    from horizongs_tpu.data.synthetic import lookat_camera, random_gaussians
    from horizongs_tpu.ops.binning import build_tile_instances
    from horizongs_tpu.ops.projection import project_3dgs
    from horizongs_tpu.ops.raster import _make_grid
    n, W, H = 3000, 256, 160
    g = {k: jnp.asarray(v) for k, v in random_gaussians(
        n, seed=0, extent=1.5, scale_range=(0.004, 0.02)).items()}
    cam = lookat_camera(width=W, height=H, eye=(0, 0, -4))
    grid = _make_grid(W, H, 32, 32)
    proj = project_3dgs(g["means"], g["quats"], g["scales"], cam.viewmat,
                        cam.K, W, H)
    radii = jnp.where(g["opacities"] >= 1 / 255.0, proj.radii, 0.0)
    inst = build_tile_instances(
        proj.means2d, radii, proj.depths, grid.n_tiles_x, grid.n_tiles_y, 32,
        32, -(-6 * n // 128) * 128, conics=proj.conics,
        opacities=g["opacities"])
    args, ri = pbv.bwd_scene(n, W, H, device="cpu")
    assert int(ri.inst.n_instances) == int(inst.n_instances) > 0
    assert int(ri.inst.n_dropped) == 0
    assert bool((args[3] == 1).all()) and bool((args[4] == 0).all())
    assert (args[7], args[8]) == (grid.n_tiles_x, grid.n_tiles_y)


def test_t2_variants_on_the_cpu():
    args, _ = pbv.bwd_scene(400, 96, 64, device="cpu")
    torch.testing.assert_close(raster3d.rasterize_bwd_variant("full", *args),
                               raster3d.rasterize_bwd_plain(*args),
                               atol=0, rtol=0)
    for v in raster3d.VARIANTS[1:]:
        with pytest.raises(ValueError, match="no CPU version"):
            raster3d.rasterize_bwd_variant(v, *args)
    with pytest.raises(ValueError):
        raster3d.rasterize_bwd_variant("no_scan", *args)
    with pytest.raises(ValueError):
        raster3d.variant_occupancy("no_scan", 0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pbv.main(["--device", "cpu"])


def test_t3_plain_versions():
    n = 5
    r = np.random.default_rng(0)
    inst = torch.from_numpy(r.normal(size=(go.ROWS, 256)).astype(np.float32))
    out = torch.full((n, go.ROWS, go.P), 7.0)
    assert go.write(out) is out and bool((out == 0).all())
    torch.testing.assert_close(go.write_plain(n, "cpu"), out, atol=0, rtol=0)
    go.one_copy(inst, out)
    assert bool((out == inst[0, 0]).all())
    torch.testing.assert_close(go.one_copy_plain(inst, n), out, atol=0,
                               rtol=0)
    go.empty(n, "cpu")                        # nothing to do on the CPU
    with pytest.raises(ValueError):
        go.write(torch.zeros((n, go.ROWS, 512)))
    with pytest.raises(ValueError):
        go.one_copy(inst[:, :64].contiguous(), out)
    assert go.GRIDS == (255, 1020, 2040, 4080)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pgo.main(["--device", "cpu"])


# --- --wandb ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """A 32x32 synthetic dataset (24 train, 4 test views) and a copy of
    `configs/synthetic/quickstart.yaml` that trains on it."""
    import yaml

    from horizongs_tpu_torch.cli.make_synthetic import main as mk
    root = tmp_path_factory.mktemp("tiny_scene")
    data = str(root / "data")
    assert mk([data, "--n_train", "24", "--n_test", "4", "--width", "32",
               "--height", "32", "--n_gauss", "40", "--device", "cpu"]) == 0
    with open(ROOT / "configs" / "synthetic" / "quickstart.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model_params"]["source_path"] = data
    path = root / "quickstart.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"data": data, "config": str(path)}


class _StubRun:
    def __init__(self, **init):
        self.init, self.logged = init, []

    def log(self, data, step=None):
        self.logged.append((step, sorted(data),
                            [v for _, v in sorted(data.items())]))


def _stub_wandb(monkeypatch):
    import types
    mod = types.ModuleType("wandb")
    mod.runs = []
    mod.Image = lambda a: ("Image", tuple(np.asarray(a).shape))

    def init(**kw):
        mod.runs.append(_StubRun(**kw))
        return mod.runs[-1]
    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_wandb_without_the_package_trains_on(tiny_scene, tmp_path,
                                             monkeypatch):
    from horizongs_tpu_torch.cli.train import main as train_main
    monkeypatch.setitem(sys.modules, "wandb", None)     # import fails
    out = tmp_path / "run"
    assert train_main(["--config", tiny_scene["config"], "--model_path",
                       str(out), "--iterations", "4", "--device", "cpu",
                       "--disable_tb", "--skip_eval", "--wandb"]) == 0
    log = (out / "outputs.log").read_text()
    assert "wandb unavailable" in log and "[it      4]" in log


def test_wandb_logs_the_jax_trainers_keys_at_its_steps(tiny_scene,
                                                       tmp_path,
                                                       monkeypatch):
    """The JAX CLI and the port's CLI on one dataset, each with --wandb
    and a stub `wandb`: the same run settings, and the same keys logged
    at the same steps (progress lines, milestone evaluations of the test
    and train views with their first renders). The values are not
    compared: the JAX trainer's step and renders are stubbed out (their
    XLA compiles take a minute here; `test_torch_trainer.py` holds the
    numbers), and the keys and steps do not depend on them."""
    import jax.numpy as jnp

    import horizongs_tpu.native
    import horizongs_tpu.render
    import horizongs_tpu.train.trainer as jtrainer_mod
    import horizongs_tpu_torch.native
    from horizongs_tpu.cli.train import main as j_train_main
    from horizongs_tpu_torch.cli.train import main as train_main
    for mod in (horizongs_tpu.native, horizongs_tpu_torch.native):
        monkeypatch.setattr(mod, "available", lambda: False)

    def j_step(state, ct, it):
        return state, {"loss": jnp.float32(0.1), "psnr": jnp.float32(20.0),
                       "n_dropped": 0}
    monkeypatch.setattr(jtrainer_mod.Trainer, "_step_fn",
                        lambda self, H, W: j_step)
    monkeypatch.setattr(horizongs_tpu.render, "render",
                        lambda cam, *a, **kw: {"render": jnp.zeros(
                            (cam.height, cam.width, 3))})
    wandb = _stub_wandb(monkeypatch)
    argv = ["--config", tiny_scene["config"], "--iterations", "60",
            "--test_iterations", "20", "60", "--disable_tb", "--skip_eval",
            "--wandb", "--rasterizer", "dense"]
    assert j_train_main([*argv, "--model_path", str(tmp_path / "j")]) == 0
    assert train_main([*argv, "--model_path", str(tmp_path / "t"),
                       "--device", "cpu"]) == 0
    jrun, trun = wandb.runs
    assert {k: v for k, v in trun.init.items() if k != "config"} == {
        "project": "horizongs_tpu", "name": "quickstart"}
    assert trun.init["config"] == jrun.init["config"]
    assert [(s, k) for s, k, _ in trun.logged] == \
        [(s, k) for s, k, _ in jrun.logged]
    keys = {k for _, ks, _ in trun.logged for k in ks}
    assert {"train_total_loss", "psnr", "anchors", "test_l1", "test_psnr",
            "train_l1", "train_psnr"} <= keys
    images = [v for _, _, vs in trun.logged for v in vs
              if isinstance(v, tuple)]
    assert images and all(v == ("Image", (32, 32, 3)) for v in images)
    assert images == [v for _, _, vs in jrun.logged for v in vs
                      if isinstance(v, tuple)]


# --- the rest of the port's tools -------------------------------------------

def test_mesh_check_calibrates_as_the_trainer():
    """`tools/mesh_check._calibrate` gives the capacities the trainer's
    calibration gives over the same views, model and margins."""
    from collections import defaultdict
    from types import SimpleNamespace

    from horizongs_tpu_torch.tools import mesh_check
    from horizongs_tpu_torch.train.trainer import Trainer
    scene = mesh_check._scene(torch.device("cpu"), 64, 48, "3D", 300)
    t = object.__new__(Trainer)
    t.cfg, t.rasterizer, t.add_prefilter, t.band_cap = (
        scene["cfg"], "cuda", True, None)
    t.mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    t._cap_margin = defaultdict(lambda: 1.15)
    t._band_margin = defaultdict(lambda: 1.25)
    t._calib_views = lambda H, W, samples=6: scene["cams"]
    host = (scene["mlps"], scene["state"])
    want = (t._calibrate_cap(48, 64, host=host),
            t._calibrate_band_cap(48, 64, host=host))
    assert mesh_check._calibrate(scene, 2) == want
    assert want[1] is not None
    t.mesh = SimpleNamespace(shape={"data": 1, "model": 1})
    assert mesh_check._calibrate(scene, 1) == (
        t._calibrate_cap(48, 64, host=host), None)


def test_profile_band_overhead_on_cpu(tmp_path):
    from horizongs_tpu_torch.tools import profile_band_overhead as pbo
    out = tmp_path / "band.json"
    assert pbo.main(["--device", "cpu", "--size", "48x32", "--points",
                     "200", "--warmup", "1", "--iters", "1", "--steps", "1",
                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and "host" in rec["source"]
    assert "device_busy_ms" not in json.dumps(rec)
    for k in ("plain", "band"):
        assert rec[k]["step_ms_p50"] > 0 and rec[k]["total_ms"] > 0
        assert rec[k]["launches_per_step"] == {"K1": 0.0, "K2": 0.0}
        assert rec[k]["launches"] == {"K1": 0, "K2": 0}
        assert rec[k]["steps_run"] == 1 + 2 * 1 + 1
    assert rec["launches_process"] == rec["launches_setup"] == {
        "K1": 0, "K2": 0}
    assert rec["rows"] and rec["rows_match_total"]
    assert abs(sum(r["delta_ms"] for r in rec["rows"])
               - rec["total_diff_ms"]) <= 1e-6 * rec["plain"]["total_ms"]
    assert rec["instance_cap"]["band"] >= rec["instance_cap"]["plain"] // 2
    assert pbo.short_name(
        "void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, "
        "float, at::native::binary_internal::MulFunctor<float> > >(int)") \
        == ("elementwise_kernel: BinaryFunctor<float, float, float, "
            "MulFunctor<float> > >(int)")
    assert pbo.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul> >(int)", 40) == \
        "vectorized_elementwise_kernel: FillFunct"
    assert pbo.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"


def test_convergence_check_on_cpu(tiny_scene, tmp_path):
    """The quickstart schedule cut to 80 iterations (one densify epoch),
    single device and --mesh 1x2 (two gloo ranks)."""
    from horizongs_tpu_torch.tools import convergence_check as cc
    out = tmp_path / "conv.json"
    assert cc.main(["--device", "cpu", "--iterations", "80", "--scene",
                    tiny_scene["data"], "--workdir", str(tmp_path / "w"),
                    "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["mesh"] == "1x2"
    assert rec["launches_once_per_iteration"] is None
    single, mesh = rec["single"], rec["mesh_1x2"]
    for run in (single, mesh):
        assert np.isfinite(run["test_psnr"])
        assert run["anchor_trajectory"][-1][0] == 80
        assert all(r["iterations"] == 80 and r["rc"] == 0
                   for r in run["ranks"])
    assert len(mesh["ranks"]) == 2
    assert rec["densify_epochs"]["single"] == rec["densify_epochs"]["mesh"]
    assert rec["densify_epochs"]["single"] >= 1
    assert rec["psnr_gap_db"] == abs(single["test_psnr"] - mesh["test_psnr"])
    assert cc.anchors_from_log(str(tmp_path / "w" / "single")) == [
        tuple(x) for x in single["anchor_trajectory"]]
    # the CPU runs the plain versions: nothing is counted, in any scope
    for r in single["ranks"] + mesh["ranks"]:
        assert r["launches"] == r["launches_run"] == [0, 0]
    assert all(r["launches_process"] == [0, 0] for r in mesh["ranks"])
    # one step's kernel arguments from each run (each rank's band)
    assert len(rec["captures"]["single"]) == 1
    assert len(rec["captures"]["mesh"]) == 2
    for path in rec["captures"]["single"] + rec["captures"]["mesh"]:
        cap = torch.load(path, weights_only=False)
        assert cap["gs"] == "3D" and cap["iteration"] == 80
        fields, gauss_id, tile_starts, ntx, nty = cap["fwd"]
        assert fields.shape[1] == 10 and tile_starts.shape == (ntx * nty + 1,)
        acc, logT, n_contrib = raster3d.rasterize_fwd(*cap["fwd"])
        assert torch.isfinite(acc).all() and int(n_contrib.sum()) > 0
        assert torch.isfinite(raster3d.rasterize_bwd(*cap["bwd"])).all()
    # the two ranks composite different bands
    a, b = (torch.load(p, weights_only=False)["fwd"][2]
            for p in rec["captures"]["mesh"])
    assert not torch.equal(a, b)


def test_bench_densify_on_cpu(tmp_path):
    from horizongs_tpu_torch.tools import bench_densify as bd
    out = tmp_path / "bench.json"
    assert bd.main(["--device", "cpu", "--anchors", "2000", "--out",
                    str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["round_trip_exact"] == {"npz": True, "sharded": True}
    assert rec["capacity"] == 4096 and rec["anchors"] == 2000
    assert rec["anchors_after_densify"] == 2000 + rec["added"] - rec["pruned"]
    assert rec["pruned"] > 0
    for k in ("build_s", "densify_epoch_s", "checkpoint_save_s",
              "checkpoint_load_s", "sharded_save_s", "sharded_load_s"):
        assert rec[k] > 0, k
    assert rec["checkpoint_mb"] > sum(rec["device_mb"].values()) * 0.9
    grow = rec["grow_epoch"]
    assert grow["share"] == 0.01 and grow["candidates"] > 0
    assert 0 < grow["added"] <= grow["candidates"]
    assert grow["pruned"] == rec["pruned"]
    assert grow["anchors_after_densify"] == (
        2000 + grow["added"] - grow["pruned"])


class _Stop(Exception):
    pass


def test_bench_densify_table_and_epoch_match_the_jax_tool(monkeypatch,
                                                           tmp_path):
    """`bench_densify.build_state` and its epoch at 2,000 anchors against
    the JAX tool's (`tools/bench_densify.py`, run up to its densify epoch
    with `run_densify` recorded): every leaf of the table before and of
    the state after the epoch is equal, the decoders apart (each package
    draws its own from its own generator; only their shapes and zero
    moments are compared)."""
    from horizongs_tpu.train import densify as jdens
    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.convert import train_state_to_numpy
    from horizongs_tpu_torch.train.densify import run_densify
    from horizongs_tpu_torch.tools import bench_densify as bd
    seen = {}

    def record(cfg, opt, ts, it, **kw):
        seen["in"] = jax.tree.map(np.asarray, ts)
        seen["out"] = jax.tree.map(np.asarray,
                                   orig(cfg, opt, ts, it, **kw))
        raise _Stop
    orig = jdens.run_densify
    monkeypatch.setattr(jdens, "run_densify", record)
    spec = importlib.util.spec_from_file_location(
        "jax_bench_densify", ROOT / "tools" / "bench_densify.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["bench_densify", "--anchors", "2000",
                                      "--out", str(tmp_path / "j.json")])
    with pytest.raises(_Stop):
        tool.main()

    rng = np.random.default_rng(0)
    cfg, ts = bd.build_state(2000, 32, 10, torch.device("cpu"), rng)
    report = {}
    out = run_densify(cfg, make_optim(start_stat=0, update_interval=100,
                                      densify_grad_threshold=2e-4,
                                      min_opacity=0.005),
                      ts, 1000, stage="coarse", rng=rng, report=report)
    assert report["pruned"] > 0
    decoders = ("mlp_opacity", "mlp_cov", "mlp_color", "appearance")

    def flat(d, prefix=""):
        r = {}
        for key, v in d.items():
            if isinstance(v, dict):
                r.update(flat(v, f"{prefix}{key}."))
            elif v is not None:
                r[f"{prefix}{key}"] = np.asarray(v)
        return r

    def jax_flat(j):
        groups = lambda tp: {f: getattr(tp, f) for f in tp._fields}
        return flat({"params": groups(j.params), "mu": groups(j.opt.mu),
                     "nu": groups(j.opt.nu), "t": int(j.opt.t),
                     "stats": groups(j.stats), "rotation": j.rotation,
                     "level": j.level, "extra_level": j.extra_level,
                     "n": int(j.n)})
    for got_state, want_state in ((ts, seen["in"]), (out, seen["out"])):
        got = flat(train_state_to_numpy(got_state))
        want = jax_flat(want_state)
        assert set(got) == set(want)
        for name, w in want.items():
            assert got[name].shape == w.shape, name
            if name.split(".")[1:2] and name.split(".")[1] in decoders:
                if name.startswith(("mu.", "nu.")):
                    assert not got[name].any() and not w.any(), name
                continue
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert int(out.n) == int(seen["out"].n) == (
        2000 + report["added"] - report["pruned"])
