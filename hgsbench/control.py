"""The control of `correct`: the plain reference put in the program's
place, computed one precision below the configuration's (TF32 matmuls
and convolutions, where the program runs float32 with TF32 off), read
against the float32 reference by the same numbers a run compares.

    python -m hgsbench.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed with its numbers and the cell's limits; a
sound limit is failed by at least one number on every seed. It needs a
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


@contextlib.contextmanager
def planted(fault: str):
    """The reference with one of a training step's faults planted:
    "half_batch" takes the L1 term's mean over the top half of the view's
    rows, leaving the rest out; "altered_answer" adds 1e-2 to the rendered
    image where it is produced."""
    from hgsbench.reference import losses, step
    saved = (losses.l1_loss, step.render)
    if fault == "half_batch":
        def l1(a, b):
            h = a.shape[0] // 2
            return torch.mean(torch.abs(a[:h] - b[:h]))
        losses.l1_loss = l1
    elif fault == "altered_answer":
        def render(*a, **k):
            pkg = saved[1](*a, **k)
            pkg["render"] = pkg["render"] + 1e-2
            return pkg
        step.render = render
    try:
        yield
    finally:
        losses.l1_loss, step.render = saved


def readings(spec, seed: int, device, fault: str = "tf32") -> dict:
    """The control's numbers for one seed, on the cell's own inputs at its
    own size: training, three steps from the cell's first iteration on
    three views drawn from the seed; the viewer, the sampled frames of the
    cell's flight. `fault` other than "tf32" reads a planted fault
    (`planted`) in float32 in place of the lower precision."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cfg, traffic = spec.cfg, spec.traffic
    if traffic["kind"] == "train":
        tables = scene.host_copy(scene.make_tables(cfg, traffic["table"],
                                                   gen, device))
        views = scene.make_views(cfg, gen, device)
        vs = torch.randint(len(views.is_aerial), (3,), generator=gen,
                           device=device).tolist()
        picks = [(traffic["first_iter"] + i, v) for i, v in enumerate(vs)]
        extent = scene.cameras_extent(views)
        ref = check.train_steps(cfg, tables, views, picks, extent, device)
        with planted(fault):
            low = check.train_steps(cfg, tables, views, picks, extent,
                                    device, tf32=fault == "tf32")
        low["names"] = ref["names"]
        out = train.compare(low, ref)
    else:
        tables = scene.host_copy(scene.make_tables(cfg, traffic["table"],
                                                   gen, device))
        requests = view.start_from(view.flight(cfg, traffic), gen)
        sample = view.sample_indices(requests, traffic["sample_frames"],
                                     gen)
        cams = [wire.parse_request(requests[i]) for i in sample]
        ref = check.render_frames(cfg, tables, cams, device)
        low = check.render_frames(cfg, tables, cams, device, tf32=True)
        out = view.compare([a.reshape(-1) for a in low], ref)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="tf32",
                    choices=("tf32", "half_batch", "altered_answer"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hgsbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = hrun.resolve(hrun.load_manifest(), args.workload)
    dev = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        nums = readings(spec, int(s), dev, args.fault)
        ok, checks = hrun.judge(nums, spec.limits)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "fault": args.fault,
                          "numbers": nums, "fails_a_limit": not ok,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
