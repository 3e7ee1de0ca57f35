"""The control of `correct`: the plain reference put in the program's
place, computed one precision below the configuration's (TF32 matmuls
and convolutions, where the program runs float32 with TF32 off), read
against the float32 reference by the same numbers a run compares.

    python -m hgsbench.control --workload <cell> --seeds 1,2,3 \
        [--fault tf32,half_batch,altered_answer,no_exchange]

prints one JSON line per seed and fault with its numbers and the cell's
limits; a sound limit is failed by at least one number on every seed.
`--fault` reads, in place of TF32, the reference with a training step's
fault planted (`planted`), in float32. It needs a
card (TF32 exists only there); the benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from hgsbench import run as hrun
from hgsbench import scene, train, view, wire
from hgsbench.reference import check


FAULTS = ("tf32", "half_batch", "altered_answer", "no_exchange")


@contextlib.contextmanager
def planted(fault: str, batch: bool = False):
    """The reference with one of a training step's faults planted:
    "half_batch" takes the L1 term's mean over the top half of the view's
    rows, leaving the rest out, or, for a data-parallel `batch`, the mean
    over the first half of the batch's views, leaving the rest out;
    "altered_answer" adds 1e-2 to the rendered image where it is produced;
    "no_exchange" (a batch) leaves out the exchange between the cards: the
    first card's view alone, with its share of the weight."""
    if fault == "no_exchange" and not batch:
        raise ValueError("no_exchange needs a data-parallel batch")
    from hgsbench.reference import losses, step
    saved = (losses.l1_loss, step.render, check._batch_grads)
    if fault == "half_batch" and not batch:
        def l1(a, b):
            h = a.shape[0] // 2
            return torch.mean(torch.abs(a[:h] - b[:h]))
        losses.l1_loss = l1
    elif fault == "half_batch":
        def half(st, ts, views, b, it):
            return saved[2](st, ts, views, b[:len(b) // 2], it)
        check._batch_grads = half
    elif fault == "no_exchange":
        def own(st, ts, views, b, it):
            loss, aux, pkg, grads, probe, ct = saved[2](st, ts, views, b[:1],
                                                        it)
            s = b[0][1] / sum(w for _, w in b)
            return (s * loss, aux, pkg,
                    {k: [s * g for g in gs] for k, gs in grads.items()},
                    probe, ct)
        check._batch_grads = own
    elif fault == "altered_answer":
        def render(*a, **k):
            pkg = saved[1](*a, **k)
            pkg["render"] = pkg["render"] + 1e-2
            return pkg
        step.render = render
    try:
        yield
    finally:
        losses.l1_loss, step.render, check._batch_grads = saved


def readings(spec, seed: int, device, fault: str = "tf32") -> dict:
    """The control's numbers for one seed, on the cell's own inputs at its
    own size: training, three steps from the cell's first iteration on
    three views (under a mesh, three batches of D views) drawn from the
    seed; the viewer, the sampled frames of the cell's flight. `fault`
    other than "tf32" reads a planted fault (`planted`) in float32 in
    place of the lower precision."""
    return readings_all(spec, seed, device, (fault,))[fault]


def readings_all(spec, seed: int, device, faults) -> dict:
    """`readings` of each of `faults` (fault -> numbers) for one seed, the
    float32 reference run once."""
    cfg, traffic = spec.cfg, spec.traffic
    bad = unplantable(traffic, faults)
    if bad:
        raise ValueError(bad)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tables = scene.host_copy(scene.make_tables(cfg, traffic["table"], gen,
                                               device))
    out = {}
    if traffic["kind"] == "train":
        views = scene.make_views(cfg, gen, device)
        if "mesh" in traffic:           # a batch of D views a step
            d = int(traffic["mesh"].lower().split("x")[0])
            vs = torch.randint(len(views.is_aerial), (3, d), generator=gen,
                               device=device).tolist()
            vs = [[(v, 1.0) for v in row] for row in vs]
        else:
            vs = torch.randint(len(views.is_aerial), (3,), generator=gen,
                               device=device).tolist()
        picks = [(traffic["first_iter"] + i, v) for i, v in enumerate(vs)]
        extent = scene.cameras_extent(views)
        ref = check.train_steps(cfg, tables, views, picks, extent, device)
        for fault in faults:
            with planted(fault, batch="mesh" in traffic):
                low = check.train_steps(cfg, tables, views, picks, extent,
                                        device, tf32=fault == "tf32")
            low["names"] = ref["names"]
            out[fault] = train.compare(low, ref)
    else:
        requests = view.start_from(view.flight(cfg, traffic), gen)
        sample = view.sample_indices(requests, traffic["sample_frames"],
                                     gen)
        cams = [wire.parse_request(requests[i]) for i in sample]
        ref = check.render_frames(cfg, tables, cams, device)
        low = check.render_frames(cfg, tables, cams, device, tf32=True)
        out["tf32"] = view.compare([a.reshape(-1) for a in low], ref)
    return {f: {k: v for k, v in nums.items() if not k.startswith("_")}
            for f, nums in out.items()}


def unplantable(traffic: dict, faults) -> str:
    """Why `faults` cannot be planted in a cell of `traffic` ("" where
    they can): a viewer cell reads TF32 alone, and only a cell on a mesh
    has an exchange to leave out."""
    if traffic["kind"] != "train" and set(faults) - {"tf32"}:
        return "a viewer cell reads tf32 alone"
    if "no_exchange" in faults and "mesh" not in traffic:
        return "no_exchange needs a cell on a mesh"
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="tf32",
                    help="comma-separated: tf32, half_batch, "
                    "altered_answer, no_exchange")
    args = ap.parse_args(argv)
    faults = args.fault.split(",")
    for f in faults:
        if f not in FAULTS:
            ap.error(f"unknown fault {f!r}")
    spec = hrun.resolve(hrun.load_manifest(), args.workload)
    if unplantable(spec.traffic, faults):
        ap.error(unplantable(spec.traffic, faults))
    if not torch.cuda.is_available():
        print("hgsbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        for fault, nums in readings_all(spec, int(s), dev, faults).items():
            ok, checks = hrun.judge(nums, spec.limits)
            print(json.dumps({"workload": args.workload, "seed": int(s),
                              "fault": fault, "numbers": nums,
                              "fails_a_limit": not ok, "checks": checks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
