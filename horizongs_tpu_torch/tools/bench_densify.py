"""Densify and checkpoint data motion at city scale, on the card.

    python -m horizongs_tpu_torch.tools.bench_densify [--anchors 1000000]

The JAX package's `tools/bench_densify.py` on the port, with its table:
1,000,000 anchors x 10 offsets, feat 32, LOD street_levels 6, built from
seed 0 with its statistics (positions in a 100-unit cube, levels 0-3,
offsets N(0, 0.1), features N(0, 0.3), gradient accumulators
Exp(2e-4), visit counts 0-99, opacity accumulators U(0, 50) per offset and
U(0, 5) per anchor, radii U(0, 30)): about 0.3 GB of parameters, 0.6 GB of
Adam moments and 0.2 GB of statistics on the device. Times, on the host
clock with the device waited for: the table's build and placement; one
coarse `run_densify` epoch (its decision, host grow and repack phases
too); `save_train_checkpoint` / `load_train_checkpoint` (npz), with the
file's MB; and the sharded checkpoint of a 1x1 mesh (the port's format,
`io/checkpoints.save_sharded_checkpoint`), which stands where the JAX
tool times orbax. Each loaded state must equal the saved one bit for bit
(`round_trip_exact`). The statistics are drawn in the JAX tool's order,
so its epoch adds and prunes what the JAX tool's does; with their mean
gradients near 2e-4 / 50, under the 2e-4 threshold, it adds nothing. So
a second epoch (`grow_epoch`, port only) runs on the same table with a
seeded 1% of its observed offsets given mean gradients past every
level's threshold (`with_growth`), and reports its candidates, rows
added and pruned, and phases. Writes one
JSON object to `--out` (default under `build/`); the checkpoints go to a
temporary directory that is removed.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "densify_bench.json")
# the growth epoch's share of the observed offsets given gradients past
# every level's threshold: at 1M anchors about 59,000 candidates, a
# densify epoch's growth of a few percent
GROW_SHARE = 0.01


def build_state(n: int, feat_dim: int, n_offsets: int, dev, rng):
    """(cfg, state): the JAX tool's synthetic city-scale table on `dev`."""
    from horizongs_tpu_torch.models.anchors import round_capacity
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.train.optim import TrainableParams, init_adam
    from horizongs_tpu_torch.train.step import DensifyStats, TrainState
    C, k, F = round_capacity(n), n_offsets, feat_dim
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=F, n_offsets=k,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.01, fork=2, aerial_levels=2,
                      street_levels=6, standard_dist=8.0)
    anchor = rng.uniform(-50, 50, (C, 3)).astype(np.float32)
    anchor[n:] = 0
    level = rng.integers(0, 4, C).astype(np.int32)
    level[n:] = 0
    rot = np.zeros((C, 4), np.float32)
    rot[:, 0] = 1

    def t(a, grad=False):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x.requires_grad_(True) if grad else x
    mlps = init_mlps(F, cfg.view_dim, cfg.appearance_dim, k, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0), device=dev)
    params = TrainableParams(
        anchor=t(anchor, True),
        offset=t(rng.normal(0, 0.1, (C, k, 3)).astype(np.float32), True),
        feat=t(rng.normal(0, 0.3, (C, F)).astype(np.float32), True),
        scaling_log=t(np.full((C, 6), -3.0, np.float32), True), mlps=mlps)
    f32 = np.float32
    # drawn in the JAX tool's order, so the two tables are equal
    og = rng.exponential(2e-4, C * k).astype(f32)
    od = rng.integers(0, 100, C * k).astype(f32)
    oo = rng.uniform(0, 50, C * k).astype(f32)
    ao = rng.uniform(0, 5, C).astype(f32)
    ad = rng.integers(0, 100, C).astype(f32)
    stats = DensifyStats(
        anchor_opacity_accum=t(ao), anchor_demon=t(ad),
        offset_gradient_accum=t(og), offset_denom=t(od),
        offset_opacity_accum=t(oo),
        max_radii2d=t(rng.uniform(0, 30, C * k).astype(f32)))
    state = TrainState(params=params, rotation=t(rot), level=t(level),
                       extra_level=torch.zeros(C, device=dev), n=n,
                       opt=init_adam(params), stats=stats)
    return cfg, state


def with_growth(cfg, opt, state, share: float, rng):
    """(state, candidates): `state` with a seeded `share` of its observed
    offsets (those past the `offset_mask` visit gate) given a mean
    gradient of U(1, 2) x the highest level's growth threshold, so each
    of them is a growth candidate at every level; the rest of the
    statistics and the tables are the input's."""
    st = state.stats
    k, n = cfg.n_offsets, int(state.n)
    ui_st = float(opt.update_interval) * float(opt.success_threshold)
    od = st.offset_denom.cpu().numpy()
    og = st.offset_gradient_accum.cpu().numpy().copy()
    thr = opt.densify_grad_threshold * (
        cfg.fork ** opt.update_ratio) ** (cfg.street_levels - 1)
    pick = (od > ui_st * 0.5) & (rng.random(od.shape[0]) < share)
    pick[n * k:] = False
    og[pick] = od[pick] * thr * rng.uniform(1, 2, int(pick.sum()))
    grads = torch.from_numpy(og.astype(np.float32)).to(
        st.offset_denom.device)
    return (state._replace(stats=st._replace(offset_gradient_accum=grads)),
            int(pick.sum()))


def leaves(state) -> dict:
    """Every leaf of a state as numpy, under the npz checkpoint's keys."""
    from horizongs_tpu_torch.io.checkpoints import _flat_state
    return _flat_state(state)


def bit_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _dir_mb(path) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anchors", type=int, default=1_000_000)
    ap.add_argument("--feat_dim", type=int, default=32)
    ap.add_argument("--n_offsets", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal; the card when omitted")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.io.checkpoints import (
        load_sharded_checkpoint, load_train_checkpoint,
        save_sharded_checkpoint, save_train_checkpoint)
    from horizongs_tpu_torch.parallel.mesh import make_mesh
    from horizongs_tpu_torch.train.densify import run_densify
    dev = resolve_device(args.device)

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cfg, ts = build_state(args.anchors, args.feat_dim, args.n_offsets, dev,
                          rng)
    wait()
    t_build = time.perf_counter() - t0
    capacity = int(ts.params.anchor.shape[0])
    device_mb = {
        "params": sum(x.numel() * x.element_size()
                      for g in ts.params.groups().values() for x in g) / 1e6,
        "adam_moments": sum(x.numel() * x.element_size()
                            for m in (ts.opt.mu, ts.opt.nu)
                            for g in m.values() for x in g) / 1e6,
        "stats": sum(x.numel() * x.element_size() for x in ts.stats) / 1e6}

    opt = make_optim(start_stat=0, update_interval=100,
                     densify_grad_threshold=2e-4, min_opacity=0.005)
    report = {}
    t0 = time.perf_counter()
    ts2 = run_densify(cfg, opt, ts, 1000, stage="coarse", rng=rng,
                      report=report)
    wait()
    t_densify = time.perf_counter() - t0
    ts_g, candidates = with_growth(cfg, opt, ts, GROW_SHARE,
                                   np.random.default_rng(1))
    grow_report = {}
    t0 = time.perf_counter()
    ts3 = run_densify(cfg, opt, ts_g, 1000, stage="coarse",
                      rng=np.random.default_rng(1), report=grow_report)
    wait()
    grow = {"share": GROW_SHARE, "candidates": candidates,
            "added": grow_report["added"], "pruned": grow_report["pruned"],
            "anchors_after_densify": int(ts3.n),
            "capacity_after_densify": int(ts3.params.anchor.shape[0]),
            "densify_epoch_s": time.perf_counter() - t0,
            "densify_phases_ms": {k: grow_report[k] for k in (
                "decision_ms", "grow_ms", "repack_ms")}}
    del ts_g, ts3
    del ts
    saved = leaves(ts2)

    work = Path(tempfile.mkdtemp(prefix="hgs_densify_bench_"))
    try:
        path = str(work / "chkpnt1000.npz")
        t0 = time.perf_counter()
        save_train_checkpoint(path, ts2, 1000)
        t_save = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        loaded, it = load_train_checkpoint(path, device=dev)
        wait()
        t_load = time.perf_counter() - t0
        exact_npz = it == 1000 and bit_equal(leaves(loaded), saved)
        del loaded

        mesh = make_mesh(1, 1, device=dev)
        spath = str(work / "chkpnt1000_sharded")
        t0 = time.perf_counter()
        save_sharded_checkpoint(spath, ts2, 1000, mesh)
        t_ssave = time.perf_counter() - t0
        s_mb = _dir_mb(spath)
        t0 = time.perf_counter()
        sloaded, sit = load_sharded_checkpoint(spath, device=dev, mesh=mesh)
        wait()
        t_sload = time.perf_counter() - t0
        exact_sharded = sit == 1000 and bit_equal(leaves(sloaded), saved)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "anchors": args.anchors, "capacity": capacity,
        "n_offsets": args.n_offsets, "feat_dim": args.feat_dim,
        "device_mb": device_mb,
        "anchors_after_densify": int(ts2.n),
        "capacity_after_densify": int(ts2.params.anchor.shape[0]),
        "added": report.get("added"), "pruned": report.get("pruned"),
        "build_s": t_build, "densify_epoch_s": t_densify,
        "densify_phases_ms": {k: report[k] for k in
                              ("decision_ms", "grow_ms", "repack_ms")
                              if k in report},
        "checkpoint_save_s": t_save, "checkpoint_load_s": t_load,
        "checkpoint_mb": size_mb,
        "sharded_save_s": t_ssave, "sharded_load_s": t_sload,
        "sharded_mb": s_mb,
        "grow_epoch": grow,
        "round_trip_exact": {"npz": exact_npz, "sharded": exact_sharded}}
    print(json.dumps(out, indent=1), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0 if exact_npz and exact_sharded else 1


if __name__ == "__main__":
    raise SystemExit(main())
