"""Training cells on a data x model mesh of several cards: the program's
`Trainer` under a mesh (`traffic["mesh"]`, "DxM", as `cli.train --mesh`
takes it), one process a rank, NCCL between cards (gloo on the CPU).

`run(ctx)` runs in the harness's process, which touches no card: it
starts `ctx.chips` ranks with `python -m torch.distributed.run
--standalone --nproc_per_node <chips> -m hgsbench.train_mesh ...`, waits
for every one of them, and returns rank 0's output with the cards used as
`count`. Each rank pins itself to a disjoint share of the host's cores
with a thread count to match, makes the benchmark's table and views from
the seed on its own card (the same on every rank), builds the trainer on
the mesh and drives it with the one-card driver's own functions
(`hgsbench.train.set_up`, `drive`, `judge_steps`): three set-up
iterations, one `train()` call each, each a batch of D views that the
trainer picks and weighs; a warm-up whose rate, rank 0's, sizes the
window on every rank; the window, one `train()` call. Rank 0 keeps the
result, with the peak of the fullest card, every rank's step times and
the JAX modules any rank had loaded after its window (`forbidden`, which
`hgsbench.run` refuses); in a traced run, one more iteration after the
window counts the bytes the collectives carry
(`parallel.collectives.STATS`). Once its trainer is freed, rank 0 runs
the reference over the three batches: each view's gradient, weighted as
the trainer weighed it, one Adam step a batch
(`reference.check.train_steps`).

The densify epochs are not followed under a mesh: a traffic file inside
the densify window is refused.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from hgsbench import run as hrun
from hgsbench.train import Stages, drive, judge_steps, release, set_up


def mesh_shape(traffic: dict) -> tuple:
    data, model = traffic["mesh"].lower().split("x")
    return int(data), int(model)


def run(ctx) -> dict:
    data, model = mesh_shape(ctx.traffic)
    if data * model != ctx.chips:
        raise ValueError(f"mesh {ctx.traffic['mesh']} on {ctx.chips} "
                         f"card(s)")
    op = ctx.cfg["yaml"]["optim_params"]
    if (op["densification"]
            and ctx.traffic["first_iter"] < op["update_until"]):
        raise ValueError("the mesh driver does not follow densify epochs: "
                         "start past update_until")
    cell = os.path.join(ctx.tmpdir, "cell.json")
    with open(cell, "w") as f:
        json.dump({"cfg": ctx.cfg, "traffic": ctx.traffic}, f)
    out_path = os.path.join(ctx.tmpdir, "rank0.pt")
    # the harness's start on the wall clock, from which each rank reads
    # the set-up time
    start = time.time() - (time.perf_counter() - ctx.t0)
    env = dict(os.environ, PYTHONPATH=ctx.root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(ctx.chips), "-m", "hgsbench.train_mesh",
         cell, str(ctx.seed), repr(ctx.seconds), str(int(ctx.trace)),
         ctx.device.type, ctx.tmpdir, repr(start), out_path],
        env=env, cwd=ctx.root, stdout=2, check=True)
    out = torch.load(out_path, weights_only=False)
    out["count"] = ctx.chips
    return out


def pin_cores(local_rank: int, local_world: int) -> list:
    """Pin this process to the `local_rank`-th of `local_world` disjoint
    shares of the cores it may use, and give torch as many threads (at
    most 4). Returns the share."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // local_world)
    share = cores[local_rank * per:(local_rank + 1) * per] or cores
    os.sched_setaffinity(0, share)
    torch.set_num_threads(min(4, len(share)))
    return share


def rank_main(argv: list) -> None:
    import torch.distributed as dist
    from horizongs_tpu_torch.parallel import collectives
    from horizongs_tpu_torch.parallel.mesh import (maybe_init_distributed,
                                                   parse_mesh_spec)
    cell, seed, seconds, trace, dev_type, tmpdir, start, out_path = argv
    seed, seconds, trace = int(seed), float(seconds), bool(int(trace))
    # the harness's start on this process's perf_counter clock
    t0 = time.perf_counter() - (time.time() - float(start))
    rank = int(os.environ["RANK"])
    share = pin_cores(int(os.environ["LOCAL_RANK"]),
                      int(os.environ["LOCAL_WORLD_SIZE"]))
    with open(cell) as f:
        spec = json.load(f)
    cfg, traffic = spec["cfg"], spec["traffic"]
    on_cpu = dev_type == "cpu"
    maybe_init_distributed(device="cpu" if on_cpu else None)
    mesh = parse_mesh_spec(traffic["mesh"], device="cpu" if on_cpu else None)
    dev, n_data = mesh.device, mesh.shape["data"]
    stages = Stages(dev)
    model_path = os.path.join(tmpdir, f"rank{rank}", "model")
    tr, s = set_up(cfg, traffic, seed, dev, model_path, stages, mesh=mesh,
                   keep_reference=rank == 0)

    def agree(rate):
        # rank 0's warm-up rate sizes every rank's window
        rates = [rate]
        dist.broadcast_object_list(rates, src=0)
        return rates[0]
    out, _ = drive(tr, cfg, traffic, seconds, trace, dev, stages, t0,
                   model_path, agree=agree, views_per_step=n_data)
    records = out["records"]
    comm = None
    if trace:
        # the bytes the collectives carry in one step, outside the window
        # (the counting synchronises the device around each collective)
        tr.records = {k: [] for k in records}
        collectives.reset_stats(timing=True)
        end = out["window_first"] + out["attempted"] // n_data
        tr.train(iterations=end, first_iter=end)
        comm = json.loads(json.dumps(collectives.STATS["ops"]))
        collectives.reset_stats()
    ranks = [None] * mesh.shape["data"] * mesh.shape["model"]
    dist.all_gather_object(ranks, {
        "rank": rank, "peak": out["memory_peak_bytes"], "cores": len(share),
        "step_ms": records["step_ms"],
        "forbidden": hrun.forbidden_modules()})
    program_spans = None
    if trace and rank == 0:
        from horizongs_tpu_torch import tracing
        program_spans = tracing.snapshot()
    del tr
    release(dev)
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return

    peak_all = max(r["peak"] for r in ranks)
    out["memory_peak_bytes"] = peak_all
    out["e2e"]["peak_mem_gib"] = peak_all / 2 ** 30
    out.update(collectives=comm, program_spans=program_spans)
    judge_steps(out, s, cfg, dev, stages, trace)
    out["numbers"]["_ranks"] = rank_summary(ranks)
    out["stages"] = stages.times
    # what every rank had loaded after its window, and rank 0 after the
    # reference
    out["forbidden"] = sorted(set(hrun.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    torch.save(out, out_path)


def rank_summary(ranks: list) -> list:
    """Each rank's median step ms over the window, and the mean of its
    first and of its last tenth of steps (at least 5 each)."""
    out = []
    for r in ranks:
        xs = r["step_ms"]
        k = max(5, len(xs) // 10)
        out.append({"rank": r["rank"], "cores": r["cores"],
                    "peak_gib": r["peak"] / 2 ** 30,
                    "step_ms_p50": sorted(xs)[len(xs) // 2] if xs else None,
                    "first_ms": sum(xs[:k]) / len(xs[:k]) if xs else None,
                    "last_ms": sum(xs[-k:]) / len(xs[-k:]) if xs else None})
    return out


if __name__ == "__main__":
    rank_main(sys.argv[1:])
