"""One rank of a gloo mesh on the CPU, for the port's mesh tests
(`test_torch_parallel.py`, `test_torch_mesh_trainer.py`). Imports no JAX.

    python tests/torch_mesh_worker.py <case> <rank> <world> <dir>

Reads `<dir>/spec.pt`, joins the process group through a `file://` store
in <dir> (no TCP port, so parallel test workers never collide), runs the
case and writes `<dir>/rank<rank>.pt`. Cases:

  step     one sharded step (`parallel/step.py`) on the state in
           `<dir>/state.npz` and the batch in the spec: the loss, the
           reduced gradients, the metrics, the side counts and the state
           after Adam (this rank's rows);
  cli      `cli.train.main` with the spec's argv at the spec's mesh: the
           loss history, the batches picked, the densify reports and the
           rank's final rows;
  restore  a sharded checkpoint loaded at this mesh (`Trainer.restore`'s
           rule) and gathered back;
  densify  one epoch of `densify.run_densify_sharded` on the state in
           `<dir>/state.npz`, gathered back.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)


def _cams(spec):
    from horizongs_tpu_torch.train.step import CameraTensors
    return [CameraTensors(**c) for c in spec["cams"]]


def _step(spec, mesh, out_dir):
    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.convert import train_state_to_numpy
    from horizongs_tpu_torch.io.checkpoints import load_train_checkpoint
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, shard_state)
    cfg = ModelConfig(**spec["cfg"])
    state, _ = load_train_checkpoint(os.path.join(out_dir, "state.npz"),
                                     device="cpu")
    local = shard_state(state, mesh)
    step = build_sharded_train_step(cfg, make_optim(**spec["opt"]), mesh,
                                    spec["H"], spec["W"], **spec["step"])
    it = spec["iteration"]
    cams = _cams(spec)
    loss, aux, side, grads, probe_grad = step.value_and_grad(local, cams, it)
    new, metrics = step.update(local, cams, it, loss, aux, side, grads,
                               probe_grad)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: [g.detach().clone() for g in v]
                      for k, v in grads.items()},
            "probe_grad": probe_grad.clone(),
            "n_records": int(side["n_records"]),
            "n_instances": int(side["n_instances"]),
            "state": train_state_to_numpy(new)}


def _cli(spec, mesh, out_dir):
    from horizongs_tpu_torch.cli.train import main
    from horizongs_tpu_torch.convert import train_state_to_numpy
    from horizongs_tpu_torch.train import trainer as tmod
    runs, picks = [], []
    orig_train, orig_batch = tmod.Trainer.train, tmod.Trainer._pick_batch

    def train(self, *a, **kw):
        hist = orig_train(self, *a, **kw)
        runs.append((self, hist))
        return hist

    def pick_batch(self, stacks, n):
        cams, wts = orig_batch(self, stacks, n)
        picks.append(([int(c.uid) for c in cams], wts))
        return cams, wts
    tmod.Trainer.train = train
    tmod.Trainer._pick_batch = pick_batch
    assert main(spec["argv"]) == 0
    tr, hist = runs[-1]
    # the npz capture of the same state, beside the sharded checkpoint
    tr.checkpoint_format = "npz"
    tr.save_checkpoint(spec["npz_iteration"])
    return {"history": hist, "picks": picks,
            "densify": tr.records["densify"],
            "overflows": tr.records["overflows"],
            "capacity_local": int(tr.state.params.anchor.shape[0]),
            "state": train_state_to_numpy(tr.state)}


def _restore(spec, mesh, out_dir):
    from horizongs_tpu_torch.convert import train_state_to_numpy
    from horizongs_tpu_torch.io.checkpoints import (
        load_sharded_checkpoint, sharded_checkpoint_capacity)
    from horizongs_tpu_torch.parallel.step import shard_state, unshard_state
    from horizongs_tpu_torch.train.densify import pad_state_capacity
    path = spec["path"]
    C = sharded_checkpoint_capacity(path)
    n_model = mesh.shape["model"]
    if C % n_model == 0:
        local, it = load_sharded_checkpoint(path, device="cpu", mesh=mesh)
    else:
        host, it = load_sharded_checkpoint(path, device="cpu")
        local = shard_state(pad_state_capacity(
            host, -(-C // n_model) * n_model), mesh)
    return {"iteration": it, "local": train_state_to_numpy(local),
            "full": train_state_to_numpy(unshard_state(local, mesh))}


def _densify(spec, mesh, out_dir):
    import numpy as np

    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.convert import train_state_to_numpy
    from horizongs_tpu_torch.io.checkpoints import load_train_checkpoint
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.parallel.step import shard_state, unshard_state
    from horizongs_tpu_torch.train.densify import run_densify_sharded
    state, _ = load_train_checkpoint(os.path.join(out_dir, "state.npz"),
                                     device="cpu")
    report = {}
    new = run_densify_sharded(
        ModelConfig(**spec["cfg"]), make_optim(**spec["opt"]),
        shard_state(state, mesh), mesh, 100,
        rng=np.random.default_rng(spec["seed"]),
        capacity_block=spec["capacity_block"], report=report)
    return {"full": train_state_to_numpy(unshard_state(new, mesh)),
            "report": report}


CASES = {"step": _step, "cli": _cli, "restore": _restore,
         "densify": _densify}


def main(case, rank, world, out_dir):
    import torch.distributed as dist

    from horizongs_tpu_torch.parallel.mesh import init_distributed, make_mesh
    spec = torch.load(os.path.join(out_dir, "spec.pt"), weights_only=False)
    init_distributed(rank, world, "file://" + os.path.join(out_dir, "store"),
                     device="cpu")
    mesh = make_mesh(spec["data"], spec["model"], device="cpu")
    out = CASES[case](spec, mesh, out_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
