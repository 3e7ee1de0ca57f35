"""Training cells: `Trainer.train` over the benchmark's block.

Set-up makes the table and the views from the seed, builds the program's
trainer on them, and drives it through its first three iterations, one
`train()` call each (the window's own call and feed), reading the loss of
each, the first gradient as Adam holds it (its first moment over
1 - beta1) and, after the third, each leaf's change. Further warm-up
iterations give the rate from which the window's iteration count is
sized. The window is one `train()` call (the trainer keeps its densify
counters in locals, so only one call reaches its epochs). A traced run
has the trainer's profiler trace a stretch of the window and keeps the
compositors' arguments of its first steps.

After the window the reference repeats the three set-up steps on the
benchmark's own copy of the initial table, on the views the trainer drew,
and compares the densify statistics they leave. The window's first
densify epoch is compared from the state it was handed: its statistics
come from the program's own steps (about 150 of them), which the
reference does not follow; the reference runs the epoch's decision,
growth, pruning and repack on a host copy of that state and compares the
tables the program's epoch left, row by row.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time

import torch

from hgsbench import capture, scene
from hgsbench.reference import check
from hgsbench.reference import densify as ref_densify

ADAM_B1 = 0.9


def _norms(tensors) -> list:
    return [float(torch.linalg.norm(t.detach().double())) for t in tensors]


def _initial_leaves(t: scene.Tables) -> list:
    return ([t.anchor, t.offset, t.feat, t.scaling_log]
            + [x for name in ("opacity", "cov", "color") for x in t.mlp[name]])


def window_iterations(traffic: dict, seconds: float, rate: float) -> int:
    """Iterations that fill `seconds` at `rate` views/s, as `quantum` x k
    + `offset` (k >= `min_quanta`): with the quantum the densify epochs'
    spacing and the offset half of it, every window ends between two
    epochs."""
    q, off = traffic.get("quantum", 1), traffic.get("offset", 0)
    k = max(traffic.get("min_quanta", 1),
            int(round((seconds * rate - off) / q)))
    return q * k + off


def run(ctx) -> dict:
    from hgsbench import program
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    stages = Stages(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    tables = scene.make_tables(cfg, traffic["table"], gen, dev)
    views = scene.make_views(cfg, gen, dev)
    ref_tables = scene.host_copy(tables)
    extent = scene.cameras_extent(views)
    stages.mark("scene_s")
    tr = program.trainer(cfg, tables, views, ctx.seed,
                         os.path.join(ctx.tmpdir, "model"), dev)
    del tables
    stages.mark("program_s")

    # the three steps the reference follows, one train() call each
    first = traffic["first_iter"]
    picks, losses = [], []
    with capture.step_picks(tr, picks):
        for i in range(3):
            it = first + i
            losses += tr.train(iterations=it, first_iter=it)
            if i == 0:
                mu = [m for ms in tr.state.opt.mu.values() for m in ms]
                grad_norms = [n / (1.0 - ADAM_B1) for n in _norms(mu)]
                names = check.leaf_names(tr.state.params.groups())
    stat_norms = {k: float(torch.linalg.norm(v.detach().double()))
                  for k, v in tr.state.stats._asdict().items()}
    now = check.leaves(tr.state.params.groups())
    change_norms = [float(torch.linalg.norm(
        (a.detach() - b.to(dev)).double()))
        for a, b in zip(now, _initial_leaves(ref_tables))]
    del now
    stages.mark("first_steps_s")

    # warm-up: the rate that sizes the window
    warm = traffic["warmup_iterations"]
    tr.records = {k: [] for k in tr.records}
    tr.train(iterations=first + 3 + warm - 1, first_iter=first + 3)
    tail = tr.records["iteration_ms"][2:]
    rate = 1e3 / (sum(tail) / len(tail))
    # host buffers for the copy of the window's first densify epoch
    start = first + 3 + warm
    op = cfg["yaml"]["optim_params"]
    epochs = (op["densification"]
              and op["update_from"] < start < op["update_until"])
    bufs = capture.epoch_buffers(tr.state) if epochs else None
    stages.mark("warmup_s")
    setup_s = time.perf_counter() - ctx.t0

    # the window
    n_it = window_iterations(traffic, ctx.seconds, rate)
    tr.records = {k: [] for k in tr.records}
    calls, epoch = [], {}
    if ctx.trace:
        tr.profile_steps = (start + traffic["trace_from"],
                            traffic["trace_steps"])
        hook = capture.compositor_calls(tr, calls, traffic["trace_calls"])
    else:
        hook = contextlib.nullcontext()
    with hook, (capture.first_epoch(epoch, bufs) if epochs
                else contextlib.nullcontext()):
        t0 = time.perf_counter()
        tr.train(iterations=start + n_it - 1, first_iter=start)
        _sync(dev)
        window_s = time.perf_counter() - t0
    stages.mark("window_s")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {
        "attempted": n_it, "failed": 0,
        "e2e": {"train_views_per_s": n_it / window_s,
                "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        "memory_peak_bytes": peak, "window_s": window_s,
        "records": tr.records, "window_first": start, "calls": calls,
        # rows of the window the profiler slowed: its stretch, and the
        # iteration whose start stops it and writes the trace
        "traced_rows": ((traffic["trace_from"],
                         traffic["trace_from"] + traffic["trace_steps"])
                        if ctx.trace else None),
        "trace_path": (os.path.join(ctx.tmpdir, "model", "profile",
                                    "trace.json") if ctx.trace else None),
        "epochs": len(tr.records["densify"]),
    }
    if ctx.trace:
        out["calls"] = capture.count_calls(calls, cfg, ref_tables, views,
                                           dev)
        stages.mark("counts_s")
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference over the same three steps, and over the first epoch
    ref = check.train_steps(cfg, ref_tables, views, picks, extent, dev)
    stages.mark("reference_s")
    out["numbers"] = compare(
        {"losses": losses, "grad_norms": grad_norms,
         "change_norms": change_norms, "stat_norms": stat_norms,
         "names": names}, ref)
    if epoch:
        ref_ep = ref_densify.epoch(
            check.model_config(cfg), check.optim(cfg), epoch["before"], dev,
            epoch["stage"], epoch["cam_infos"], epoch["weed_ratio"])
        out["numbers"].update(
            densify_rows_off=ref_densify.rows_off(epoch["after"], ref_ep),
            _epoch={"iteration": epoch["iteration"], "added": ref_ep["added"],
                    "pruned": ref_ep["pruned"], "copy_s": epoch["copy_s"]})
        stages.mark("reference_epoch_s")
    out["stages"] = stages.times
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stages:
    """Host seconds of a run's stages, the device waited for at each
    mark (reported beside the result, for the reader of a run)."""

    def __init__(self, dev):
        self.dev, self.times = dev, {}
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        _sync(self.dev)
        now = time.perf_counter()
        self.times[name] = now - self.t
        self.t = now


def leaf_gaps(prog: list, ref: list, ref_grad: list, names: list):
    """Each leaf's |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (their
    change is round-off alone). Returns (the worst gap, its leaf, the
    median leaf's gap)."""
    med_g = sorted(ref_grad)[len(ref_grad) // 2]
    med = sorted(ref)[len(ref) // 2]
    gaps = {name: abs(p - r) / max(r, med, 1e-30)
            for p, r, g, name in zip(prog, ref, ref_grad, names)
            if g >= 1e-3 * med_g}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, sorted(gaps.values())[len(gaps) // 2]


def compare(prog: dict, ref: dict) -> dict:
    """The readings `correct` may compare (the cell's limits name those it
    does): the largest relative gap of the three steps' losses, that of
    the first step's alone, the worst and the median leaf's gap of the
    first gradient's norm, the worst leaf's gap of the change's norm, and
    the worst densify statistic's
    relative gap of norms after the three steps (a statistic that is zero
    in the reference reads 1 where the program's is not)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["losses"], ref["losses"])]
    grad_gap, grad_leaf, grad_med_gap = leaf_gaps(
        prog["grad_norms"], ref["grad_norms"], ref["grad_norms"],
        ref["names"])
    change_gap, change_leaf, _ = leaf_gaps(
        prog["change_norms"], ref["change_norms"], ref["grad_norms"],
        ref["names"])
    stats_gap = max((abs(prog["stat_norms"][k] - r) / r if r > 0
                     else float(prog["stat_norms"][k] != 0.0))
                    for k, r in ref["stat_norms"].items())
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "grad_med_gap": grad_med_gap,
            "change_gap": change_gap, "stats_gap": stats_gap,
            "_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf},
            "_program": prog, "_reference": ref}
