"""The port's serving and export CLIs on the CPU (`--device cpu`), on tiny
model directories the port's train CLI writes: `cli.render` (the sets,
the fly-through, the explicit model), `cli.metrics` (against
`evaluate_sets` of the PNGs it reads), `cli.export_mesh` (bounded and
unbounded) and `cli.convert` without a `colmap` binary. The port's mesh
export is held to the JAX package's on one 2DGS model directory that the
JAX package wrote (its Scene's save of its initial state with seeded
features and rotations): the same voxels observed the same number of
times, the two TSDF grids within 1e-3 of the truncation band there, and
the mesh vertex counts within 1%. Also: the train CLI's `--profile` and
`--detect_anomaly`, and with no card and no `--device` every CLI
raises."""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from horizongs_tpu_torch.cli import export_mesh as t_export
from horizongs_tpu_torch.cli.make_synthetic import main as make_synthetic
from horizongs_tpu_torch.cli.train import main as train_main
from horizongs_tpu_torch.train import trainer as ttrainer_mod
from horizongs_tpu_torch.utils.meshing import read_mesh_ply

torch.set_num_threads(1)

W = H = 48
MODEL = {"fork": 2, "gs_attr": "3D", "color_attr": "SH1", "feat_dim": 8,
         "view_dim": 0, "appearance_dim": 0, "n_offsets": 4,
         "voxel_size": 0.3, "render_mode": "RGB+ED", "standard_dist": 8.0,
         "aerial_levels": 2, "street_levels": 4}


def write_dataset(path: str) -> str:
    assert make_synthetic([path, "--n_train", "6", "--n_test", "2",
                           "--width", str(W), "--height", str(H),
                           "--n_gauss", "40", "--device", "cpu"]) == 0
    return path


def write_config(path, dataset: str, **model_kwargs) -> str:
    cfg = {
        "model_params": {
            "model_config": {"name": "GaussianLoDModel",
                             "kwargs": {**MODEL, **model_kwargs}},
            "dataset_name": "synth", "scene_name": "tiny",
            "data_format": "blender", "source_path": dataset, "eval": True,
            "resolution": 1},
        "pipeline_params": {"camera_balance": True,
                            "camera_proportion": "2-1",
                            "aerial_densify": True, "add_prefilter": True},
        "optim_params": {"iterations": 20, "start_stat": 5,
                         "update_from": 20, "update_interval": 15,
                         "update_until": 50},
    }
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def train_model(root, dataset: str, name: str, *argv, **model_kwargs
                ) -> str:
    """A model directory the port's train CLI writes (20 iterations)."""
    out = os.path.join(str(root), name)
    cfg = write_config(os.path.join(str(root), f"{name}.yaml"), dataset,
                       **model_kwargs)
    assert train_main(["--config", cfg, "--model_path", out, "--device",
                       "cpu", "--disable_tb", "--skip_eval", *argv]) == 0
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("serve_data")))


@pytest.fixture(scope="module")
def sh_model(dataset, tmp_path_factory):
    """3DGS with view-independent SH1 colours: the save bakes it."""
    return train_model(tmp_path_factory.mktemp("sh"), dataset, "sh")


@pytest.fixture(scope="module")
def surfel_model(dataset, tmp_path_factory):
    return train_model(tmp_path_factory.mktemp("surfel"), dataset, "surfel",
                       gs_attr="2D", color_attr="RGB", view_dim=3)


def test_render_cli_sets_path_and_explicit(sh_model):
    from horizongs_tpu_torch.cli.render import main as render_main
    assert render_main(["-m", sh_model, "--device", "cpu", "--path_video",
                        "--path_frames", "3"]) == 0
    for name, n in (("train", 6), ("test", 2)):
        for sub in ("renders", "gt", "errors"):
            got = glob.glob(os.path.join(sh_model, name, "ours_20", sub,
                                         "*.png"))
            assert len(got) == n, (name, sub)
    assert len(glob.glob(os.path.join(sh_model, "path_frames",
                                      "*.png"))) == 3
    with open(os.path.join(sh_model, "test", "ours_20",
                           "per_view_count.json")) as f:
        neural_counts = json.load(f)
    assert min(neural_counts.values()) > 0
    # the baked model: its own PLY, rendered through the same path
    assert os.path.exists(os.path.join(
        sh_model, "point_cloud", "iteration_20", "point_cloud_explicit.ply"))
    assert render_main(["-m", sh_model, "--device", "cpu", "--explicit",
                        "--skip_train"]) == 0
    with open(os.path.join(sh_model, "test", "ours_20",
                           "per_view_count.json")) as f:
        assert min(json.load(f).values()) > 0


def test_metrics_cli_scores_the_written_pngs(sh_model):
    from horizongs_tpu_torch.cli.metrics import main as metrics_main
    from horizongs_tpu_torch.cli.metrics import read_images
    from horizongs_tpu_torch.cli.render import main as render_main
    from horizongs_tpu_torch.train.evaluate import evaluate_sets
    assert render_main(["-m", sh_model, "--device", "cpu",
                        "--skip_train"]) == 0
    assert metrics_main(["-m", sh_model, "--device", "cpu"]) == 0
    with open(os.path.join(sh_model, "results_test_metrics.json")) as f:
        res = json.load(f)["ours_20"]["all"]
    it_dir = os.path.join(sh_model, "test", "ours_20")
    renders, gts, names = read_images(os.path.join(it_dir, "renders"),
                                      os.path.join(it_dir, "gt"))
    assert names == ["00000.png", "00001.png"]
    want = evaluate_sets("", 20, renders, gts, ["aerial"] * 2,
                         device="cpu")["all"]
    assert res["n_views"] == 2 and math.isfinite(res["PSNR"])
    assert res["PSNR"] == want["PSNR"] and res["SSIM"] == want["SSIM"]
    assert res["LPIPS"] is None           # no VGG weights on this machine


@pytest.mark.parametrize("unbounded", [False, True],
                         ids=["bounded", "unbounded"])
def test_export_mesh_cli(surfel_model, unbounded):
    argv = ["-m", surfel_model, "--device", "cpu", "--resolution", "32"]
    assert t_export.main(argv + (["--unbounded"] if unbounded else [])) == 0
    verts, faces = read_mesh_ply(os.path.join(surfel_model,
                                              "mesh_iteration_20.ply"))
    assert faces.shape[0] > 0 and np.isfinite(verts).all()
    assert faces.max() < verts.shape[0]


def test_export_mesh_matches_jax(dataset, tmp_path, monkeypatch):
    """One model directory, written by the JAX package, exported by both
    CLIs: the JAX one through its Pallas 2DGS compositor in interpret
    mode, the port's through the plain K3."""
    from horizongs_tpu.cli.common import load_config as j_load_config
    from horizongs_tpu.cli.export_mesh import main as j_export_main
    from horizongs_tpu.data.scene import Scene as JScene
    from horizongs_tpu.utils import meshing as j_meshing

    out = str(tmp_path / "jax_surfel")
    cfg_path = write_config(tmp_path / "cfg.yaml", dataset, gs_attr="2D",
                            color_attr="RGB", view_dim=3)
    lp, _, _, cfg = j_load_config(cfg_path, out)
    scene = JScene(lp, cfg)
    # seeded features and rotations on the live rows: at their initial
    # identity rotation the surfels are exactly edge-on to the synthetic
    # street cameras, where the prefilter's radius is decided by the last
    # ulp of exp(scaling_log) in either package
    ts = scene.train_state
    rng = np.random.default_rng(5)
    live = (np.arange(ts.params.feat.shape[0]) < int(ts.n))[:, None]
    feat = rng.normal(size=ts.params.feat.shape).astype(np.float32) * live
    rot = rng.normal(size=ts.rotation.shape).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    rot = np.where(live, rot, np.asarray(ts.rotation))
    scene.save(1, ts._replace(params=ts.params._replace(feat=feat),
                              rotation=rot))
    with open(os.path.join(out, "config.yaml"), "w") as f:
        with open(cfg_path) as g:
            f.write(g.read())

    grids = {}

    def capture(name, fuse):
        def fn(*args, **kw):
            grids[name] = fuse(*args, **kw)
            return grids[name]
        return fn

    monkeypatch.setattr(j_meshing, "fuse_tsdf",
                        capture("jax", j_meshing.fuse_tsdf))
    monkeypatch.setattr(t_export, "fuse_tsdf",
                        capture("torch", t_export.fuse_tsdf))
    argv = ["-m", out, "--resolution", "48"]
    assert j_export_main(argv + ["--rasterizer", "pallas_interpret"]) == 0
    vj, fj = read_mesh_ply(os.path.join(out, "mesh_iteration_1.ply"))
    assert t_export.main(argv + ["--device", "cpu"]) == 0
    vt, ft = read_mesh_ply(os.path.join(out, "mesh_iteration_1.ply"))

    (tj, wj), (tt, wt) = grids["jax"], grids["torch"]
    both = (wj > 0) & (wt > 0)
    assert both.sum() > 300
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(tt[both], tj[both], atol=1e-3, rtol=0)
    assert vj.shape[0] > 100
    assert abs(vt.shape[0] - vj.shape[0]) <= 0.01 * vj.shape[0]


def test_convert_without_colmap(tmp_path):
    from horizongs_tpu_torch.cli.convert import main as convert_main
    assert convert_main(["-s", str(tmp_path), "--colmap_executable",
                         "no-such-colmap-binary"]) == 1


def test_train_cli_profile_and_anomaly(dataset, tmp_path, monkeypatch):
    """`--profile 3` writes a trace of iterations 20-22; `--detect_anomaly`
    trains with anomaly mode on and leaves it off afterwards."""
    seen = []
    orig = ttrainer_mod.Trainer.train

    def train(self, *args, **kw):
        seen.append(torch.is_anomaly_enabled())
        return orig(self, *args, **kw)
    monkeypatch.setattr(ttrainer_mod.Trainer, "train", train)
    out = train_model(tmp_path, dataset, "prof", "--profile", "3",
                      "--iterations", "24")
    trace = os.path.join(out, "profile", "trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    train_model(tmp_path, dataset, "anomaly", "--detect_anomaly",
                "--iterations", "3")
    assert seen == [False, True]
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("cli", ["render", "metrics", "view",
                                 "export_mesh"])
def test_cli_needs_a_card_by_default(cli, sh_model):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    import importlib
    main = importlib.import_module(f"horizongs_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-m", sh_model])
