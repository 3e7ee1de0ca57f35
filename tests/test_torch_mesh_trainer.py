"""The port's trainer, train CLI and sharded checkpoints on a mesh, on the
CPU in gloo ranks (`torch_mesh_worker.py`):

  * `cli.train --mesh 1x2` (40 iterations of a 48x48 synthetic dataset, a
    densify epoch, a sharded checkpoint) against the single-device CLI on
    the same config and seed: the loss history rtol 1e-4 up to the first
    densify epoch (the band composite sums in another order, and the
    epoch's thresholds may then fall differently), the same picks on both
    ranks and in the single-device run;
  * that sharded checkpoint restored at 1x1, 2x1 and 1x3 (where the
    capacity is re-padded), each equal to the npz capture of the same
    state; a resume from it at 1x1 after the densify epoch grew the table;
  * `densify.run_densify_sharded` against `run_densify` on the whole state,
    exactly;
  * the launch through `python -m torch.distributed.run`;
  * the cost-balanced batch fill on a mixed-resolution dataset, against
    the JAX trainer's, which takes an uncosted view for a perfect match.
"""
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horizongs_tpu.train.trainer as jtrainer_mod
from horizongs_tpu.config import make_pipeline as j_make_pipeline
from horizongs_tpu_torch.cli.make_synthetic import main as make_synthetic
from horizongs_tpu_torch.cli.train import main as train_main
from horizongs_tpu_torch.config import make_optim, make_pipeline
from horizongs_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from horizongs_tpu_torch.io.checkpoints import (
    load_sharded_checkpoint,
    load_train_checkpoint,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.train import densify as tdens
from horizongs_tpu_torch.train import trainer as ttrainer_mod
from horizongs_tpu_torch.train.trainer import Trainer
from test_torch_cli import _config, _psnr
from test_torch_densify import LOD, OPT, _j_state
from test_torch_parallel import ROOT, run_mesh
from test_torch_train import _np

torch.set_num_threads(1)

W = H = 48
ITERS = 40


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_data"))
    assert make_synthetic([path, "--n_train", "6", "--n_test", "2",
                           "--width", str(W), "--height", str(H),
                           "--n_gauss", "20", "--device", "cpu"]) == 0
    return path


def _mesh_config(path, dataset):
    cfg = _config(path, dataset)
    import yaml
    with open(cfg) as f:
        raw = yaml.safe_load(f)
    raw["optim_params"].update(iterations=ITERS, update_from=15,
                               update_interval=10, update_until=36)
    raw["pipeline_params"].update(vis_step=0, no_prefilter_step=0)
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg


@pytest.fixture(scope="module")
def mesh_run(dataset, tmp_path_factory):
    """`cli.train --mesh 1x2` in two gloo ranks: the ranks' results and
    the run directory."""
    tmp = tmp_path_factory.mktemp("mesh_run")
    cfg = _mesh_config(str(tmp / "c.yaml"), dataset)
    out = str(tmp / "mesh")
    argv = ["--config", cfg, "--model_path", out, "--device", "cpu",
            "--disable_tb", "--mesh", "1x2", "--checkpoint_iterations",
            str(ITERS)]
    res = run_mesh("cli", 1, 2, tmp, {"argv": argv,
                                      "npz_iteration": ITERS})
    return res, out, cfg


def _first_densify(res):
    return min(d["iteration"] for d in res[0]["densify"])


def test_mesh_cli_matches_single_device(mesh_run, tmp_path, monkeypatch):
    res, out, cfg = mesh_run
    runs, picks = [], []
    orig_train = ttrainer_mod.Trainer.train
    orig_pick = ttrainer_mod.Trainer._pick_camera

    def train(self, *a, **kw):
        hist = orig_train(self, *a, **kw)
        runs.append((self, hist))
        return hist

    def pick(self, stacks, cost_hint=None, res=None):
        c = orig_pick(self, stacks, cost_hint, res)
        picks.append(int(c.uid))
        return c
    monkeypatch.setattr(ttrainer_mod.Trainer, "train", train)
    monkeypatch.setattr(ttrainer_mod.Trainer, "_pick_camera", pick)
    assert train_main(["--config", cfg, "--model_path",
                       str(tmp_path / "one"), "--device", "cpu",
                       "--disable_tb"]) == 0
    tr1, hist1 = runs[-1]
    # the same picks on both ranks, and the single-device run's
    assert res[0]["picks"] == res[1]["picks"]
    assert [p[0][0] for p in res[0]["picks"]] == picks
    assert all(w == [1.0] for _, w in res[0]["picks"])
    # one history on both ranks, the single-device one's up to the first
    # densify epoch
    assert res[0]["history"] == res[1]["history"]
    first = _first_densify(res)
    assert 15 < first < ITERS
    # no step before it dropped an instance (a dropped instance changes
    # that step's loss)
    for o in res[0]["overflows"] + tr1.records["overflows"]:
        assert o["iteration"] >= first, o
    np.testing.assert_allclose(res[0]["history"][:first], hist1[:first],
                               rtol=1e-4)
    assert all(math.isfinite(x) for x in res[0]["history"])
    assert not [o for o in res[0]["overflows"] if not o["widened"]]
    assert len(res[0]["history"]) == ITERS
    assert math.isfinite(_psnr(out, ITERS))
    man = json.load(open(os.path.join(out, f"chkpnt{ITERS}_sharded",
                                      "manifest.json")))
    assert man["mesh"] == [1, 2] and man["iteration"] == ITERS


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif v is not None:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_states_equal(got: dict, want: dict, rows=None):
    """Every leaf equal; with `rows`, per-anchor leaves compared on their
    first `rows` rows (per offset: rows x k) and zero past them."""
    w = dict(_leaves(want))
    g = dict(_leaves(got))
    assert set(g) == set(w)
    for k in w:
        a, b = g[k], w[k]
        if rows is not None and a.shape != b.shape:
            per = b.shape[0] // rows
            assert np.array_equal(a[:b.shape[0]], b), k
            if k.startswith("rotation"):
                continue
            assert not a[rows * per:].any(), k
        else:
            assert a.shape == b.shape and np.array_equal(a, b), k


def test_sharded_checkpoint_restores_at_other_meshes(mesh_run, tmp_path):
    res, out, _ = mesh_run
    path = os.path.join(out, f"chkpnt{ITERS}_sharded")
    npz, it_n = load_train_checkpoint(os.path.join(out, f"chkpnt{ITERS}.npz"),
                                      device="cpu")
    want = train_state_to_numpy(npz)
    one, it = load_sharded_checkpoint(path, device="cpu")
    assert it == it_n == ITERS
    _assert_states_equal(train_state_to_numpy(one), want)
    C = npz.params.anchor.shape[0]
    for r in run_mesh("restore", 2, 1, tmp_path, {"path": path}):
        _assert_states_equal(r["full"], want)
    three = run_mesh("restore", 1, 3, tmp_path, {"path": path})
    assert C % 3 and three[0]["full"]["params"]["anchor"].shape[0] % 3 == 0
    for r in three:
        _assert_states_equal(r["full"], want, rows=C)


def test_resume_after_densify_at_1x1(mesh_run, tmp_path, monkeypatch):
    res, out, cfg = mesh_run
    assert res[0]["densify"][0]["anchors_after"] != \
        res[0]["densify"][0]["anchors_before"]
    runs = []
    orig_train = ttrainer_mod.Trainer.train

    def train(self, *a, **kw):
        runs.append(self)
        return orig_train(self, *a, **kw)
    monkeypatch.setattr(ttrainer_mod.Trainer, "train", train)
    path = os.path.join(out, f"chkpnt{ITERS}_sharded")
    assert train_main(["--config", cfg, "--model_path", str(tmp_path / "r"),
                       "--device", "cpu", "--disable_tb",
                       "--start_checkpoint", path, "--iterations",
                       str(ITERS + 4), "--skip_eval"]) == 0
    tr = runs[-1]
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert int(tr.state.n) == man["n"]
    assert tr.state.params.anchor.shape[0] == man["capacity"]


def test_densify_sharded_equals_single_device(tmp_path):
    """One epoch of the JAX-drawn LOD state with statistics far from the
    thresholds, at 1x2 against the whole state's epoch."""
    cfg_j, ts_j = _j_state(LOD, 512, 5, growing="max", pruning="max")
    ts = train_state_from_numpy(_np(ts_j), device="cpu")
    okw = dict(OPT, growing_type="max", pruning_type="max")
    want = tdens.run_densify(ModelConfig(**LOD), make_optim(**okw), ts, 100,
                             rng=np.random.default_rng(4),
                             capacity_block=64)
    assert want.n != ts.n
    res = run_mesh("densify", 1, 2, tmp_path,
                   {"cfg": LOD, "opt": okw, "seed": 4, "capacity_block": 64},
                   ts)
    for r in res:
        _assert_states_equal(r["full"], train_state_to_numpy(want))
    assert res[0]["report"]["added"] > 0


def test_torch_distributed_run_launch(dataset, tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    horizongs_tpu_torch.cli.train --mesh 1x2 --device cpu`: gloo chosen
    and logged, rank 0's files written."""
    cfg = _mesh_config(str(tmp_path / "c.yaml"), dataset)
    out = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "horizongs_tpu_torch.cli.train",
         "--config", cfg, "--model_path", out, "--device", "cpu",
         "--disable_tb", "--mesh", "1x2", "--iterations", "6",
         "--skip_eval"], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    log = p.stdout + p.stderr
    assert "backend gloo" in log
    assert os.path.isfile(os.path.join(out, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))


# --- the cost-balanced fill on a mixed-resolution dataset --------------------

class _First:
    """A `random.Random` stand-in: every random pop takes the stack's
    first view."""

    def randint(self, a, b):
        return a


def _bare_mixed(cls, pp, costs):
    """A trainer with only what `_pick_batch` reads, the costs at 64x64
    already taken."""
    t = object.__new__(cls)
    t.pp = pp
    t.rng = _First()
    t.np_rng = np.random.default_rng(0)
    t.balanced_batches = True
    t._view_costs = costs
    t._cost_res_done = {(64, 64)}
    t.log = lambda *a, **k: None
    return t


@pytest.mark.parametrize("leader", [0, 1, 2, 3])
def test_pick_batch_fills_mixed_resolution(leader):
    """The stack: the leader (64x64), 20 views at 32x32, then the other
    64x64 views; only the 64x64 views are costed. The port fills the
    2-view batch with the 64x64 view nearest in cost; the JAX trainer
    takes each uncosted 32x32 view for a perfect match, spends its 16
    tries on them and repeats the leader."""
    costs = {0: 100, 1: 900, 2: 1000, 3: 110}
    big = [SimpleNamespace(uid=u, image_type="aerial", height=64, width=64)
           for u in costs]
    small = [SimpleNamespace(uid=100 + i, image_type="aerial", height=32,
                             width=32) for i in range(20)]
    stack = [big[leader]] + small + [c for c in big if c.uid != leader]
    pp = dict(camera_balance=False)
    t = _bare_mixed(Trainer, make_pipeline(**pp),
                    {(u, 64, 64): c for u, c in costs.items()})
    j = _bare_mixed(jtrainer_mod.Trainer, j_make_pipeline(**pp), dict(costs))
    cams_t, w_t = t._pick_batch({"all": list(stack)}, 2)
    cams_j, w_j = j._pick_batch({"all": list(stack)}, 2)
    near = min((u for u in costs if u != leader),
               key=lambda u: abs(costs[u] - costs[leader]))
    assert [c.uid for c in cams_t] == [leader, near] and w_t == [1.0, 1.0]
    assert [c.uid for c in cams_j] == [leader, leader]
    assert w_j == [0.5, 0.5]
