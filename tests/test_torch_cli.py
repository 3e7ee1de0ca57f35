"""The port's train CLI on the CPU (`--device cpu`), end to end on a
written dataset: a coarse run with a densify epoch and a checkpoint, a
resume from that checkpoint, and a fine stage from the coarse output,
each with its files and a finite test PSNR; the JAX package reads the
coarse run's PLY, MLPs and checkpoint. The two CLIs start from
differently seeded decoders, so their PSNRs are not compared here
(`test_torch_trainer.py` holds the trainer to the JAX trainer). Also: the
multi-device options, refused until the mesh path was ported, are parsed
and passed on (a mesh larger than the launched world is refused; the
mesh runs themselves are in `test_torch_mesh_trainer.py`), and with no
card and no `--device` the CLI raises."""
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from horizongs_tpu.io import checkpoints as jck
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu_torch.cli.make_synthetic import main as make_synthetic
from horizongs_tpu_torch.cli.train import main as train_main
from horizongs_tpu_torch.io import checkpoints as tck
from horizongs_tpu_torch.train import trainer as ttrainer_mod

torch.set_num_threads(1)

W = H = 48
MODEL = {"name": "GaussianLoDModel", "kwargs": {
    "fork": 2, "gs_attr": "3D", "color_attr": "RGB", "feat_dim": 8,
    "view_dim": 3, "appearance_dim": 0, "n_offsets": 4, "voxel_size": 0.3,
    "render_mode": "RGB+ED", "standard_dist": 8.0, "aerial_levels": 2,
    "street_levels": 4}}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli_data"))
    assert make_synthetic([path, "--n_train", "6", "--n_test", "2",
                           "--width", str(W), "--height", str(H),
                           "--n_gauss", "40", "--device", "cpu"]) == 0
    return path


def _config(path, dataset, **model_params):
    cfg = {
        "model_params": {"model_config": MODEL, "dataset_name": "synth",
                         "scene_name": "tiny", "data_format": "blender",
                         "source_path": dataset, "eval": True,
                         "resolution": 1, **model_params},
        "pipeline_params": {"camera_balance": True,
                            "camera_proportion": "2-1",
                            "aerial_densify": True, "add_prefilter": True,
                            "vis_step": 30, "no_prefilter_step": 5},
        "optim_params": dict(iterations=60, start_stat=5, update_from=20,
                             update_interval=15, update_until=50,
                             feature_lr=0.03, mlp_color_lr_init=0.02,
                             lambda_dreg=0.0, lambda_sky_opa=0.0,
                             lambda_opacity_entropy=0.0),
    }
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture
def trainers(monkeypatch):
    """Each `Trainer.train` call's trainer and loss history."""
    runs = []
    orig = ttrainer_mod.Trainer.train

    def train(self, *args, **kw):
        hist = orig(self, *args, **kw)
        runs.append((self, hist))
        return hist
    monkeypatch.setattr(ttrainer_mod.Trainer, "train", train)
    return runs


def _psnr(model_path, it):
    with open(os.path.join(model_path, "results_test.json")) as f:
        return json.load(f)[f"ours_{it}"]["all"]["PSNR"]


def test_train_cli_coarse_resume_fine(dataset, tmp_path, trainers):
    out = str(tmp_path / "coarse")
    cfg = _config(tmp_path / "coarse.yaml", dataset)
    assert train_main(["--config", cfg, "--model_path", out, "--device",
                       "cpu", "--disable_tb", "--checkpoint_iterations",
                       "40", "60", "--test_iterations", "30"]) == 0
    tr, hist = trainers[-1]
    assert len(hist) == 60 and all(math.isfinite(x) for x in hist)
    assert np.mean(hist[-10:]) < np.mean(hist[:10])
    assert tr.records["densify"] and tr.records["densify"][0]["added"] > 0
    assert not tr.add_prefilter       # off for the last 5 iterations
    for rel in ("config.yaml", "cfg_args", "cameras.json", "input.ply",
                "outputs.log", "chkpnt40.npz", "chkpnt60.npz",
                "point_cloud/iteration_60/point_cloud.ply",
                "point_cloud/iteration_60/mlps.npz",
                "backup/horizongs_tpu_torch/cli/train.py",
                "vis/iter_000030.png", "per_view_test.json",
                "test/ours_60/renders/00000.png"):
        assert os.path.exists(os.path.join(out, rel)), rel
    assert math.isfinite(_psnr(out, 60))
    with open(os.path.join(out, "config.yaml")) as f:
        resolved = yaml.safe_load(f)
    assert resolved["model_params"]["model_path"] == out

    # the saved files are the trained state's, and the JAX package reads
    # them
    it_dir = os.path.join(out, "point_cloud", "iteration_60")
    st = tr.state.anchor_state()
    got, _ = tck.load_anchor_ply(os.path.join(it_dir, "point_cloud.ply"),
                                 tr.cfg, device="cpu")
    for f in ("anchor", "offset", "feat", "scaling_log", "level"):
        assert torch.equal(getattr(got, f)[:st.n],
                           getattr(st, f)[:st.n].detach()), f
    jst, _ = jck.load_anchor_ply(os.path.join(it_dir, "point_cloud.ply"),
                                 JConfig.from_dict(MODEL))
    np.testing.assert_array_equal(np.asarray(jst.feat)[:st.n],
                                  st.feat[:st.n].detach().numpy())
    mlps = tck.load_mlp_checkpoints(it_dir, device="cpu")
    assert torch.equal(mlps.color.w2, tr.state.params.mlps.color.w2)
    z = np.load(os.path.join(out, "chkpnt60.npz"))
    assert int(z["__iteration__"]) == 60 and int(z["n"]) == st.n

    # resume: from the checkpoint at 40 to 60
    res = str(tmp_path / "resume")
    assert train_main(["--config", cfg, "--model_path", res, "--device",
                       "cpu", "--disable_tb", "--start_checkpoint",
                       os.path.join(out, "chkpnt40.npz")]) == 0
    tr_r, hist_r = trainers[-1]
    assert len(hist_r) == 20 and all(math.isfinite(x) for x in hist_r)
    assert min(hist[20:40]) * 0.5 <= hist_r[0] <= max(hist[20:40]) * 2
    assert math.isfinite(_psnr(res, 60))

    # fine stage from the coarse output: MLPs frozen, coarse rows restored
    fine = str(tmp_path / "fine")
    cfg_f = _config(tmp_path / "fine.yaml", dataset,
                    pretrained_checkpoint=it_dir)
    assert train_main(["--config", cfg_f, "--model_path", fine, "--device",
                       "cpu", "--disable_tb", "--iterations", "40"]) == 0
    tr_f, hist_f = trainers[-1]
    assert tr_f.scene.stage == "fine"
    assert all(math.isfinite(x) for x in hist_f)
    assert torch.equal(tr_f.state.params.mlps.opacity.w1, mlps.opacity.w1)
    assert tr_f.records["densify"]
    base = tr_f.scene.base
    n_base = base["anchor"].shape[0]
    coarse_rows = np.flatnonzero(
        tr_f.state.level[:tr_f.state.n].numpy() < tr_f.cfg.aerial_levels)
    assert coarse_rows.shape[0] == n_base
    assert math.isfinite(_psnr(fine, 40))


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x2"], ["--band_cap", "64"], ["--balanced_bands"],
    ["--uniform_bands"], ["--no_balanced_batches"],
    ["--checkpoint_format", "sharded"], ["--wandb"],
    ["--rasterizer", "pallas"]])
def test_train_cli_refuses_options_not_ported(argv, tmp_path):
    """No option is refused as not ported any more: each is parsed and
    the run goes on to read its config (absent here); `--mesh 2x2` in a
    process launched alone is refused for wanting 4 ranks."""
    run = ["--config", str(tmp_path / "unread.yaml"), "--device", "cpu",
           *argv]
    if argv[0] == "--mesh":
        with pytest.raises(ValueError, match=r"needs 4 ranks, only 1"):
            train_main(run)
    else:
        with pytest.raises(FileNotFoundError, match=r"unread\.yaml"):
            train_main(run)


def test_train_cli_needs_a_card_by_default(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    cfg = _config(tmp_path / "c.yaml", dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--config", cfg, "--model_path", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic([str(tmp_path / "d")])
