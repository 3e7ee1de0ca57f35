"""Converged quality of the mesh trainer against the single-device trainer.

    python -m horizongs_tpu_torch.tools.convergence_check [--iterations N]
        [--flagship] [--device cpu]

The JAX package's `tools/convergence_check.py` on the port: the same
scene trains through the port's train CLI twice, on one device and then
at `--mesh 1x2` (two ranks launched through `torch.distributed.run`, one
process each), for enough iterations to pass every densify epoch of the
schedule, and the two are compared: test PSNR and its gap, the anchor
count trajectory (the `[it N] ... anchors=M` lines of each run's
outputs.log), the densify epochs and the overflows. `quickstart.yaml` on
the JAX tool's 64x64 scene is the default; `--flagship` trains
`flagship512.yaml` on its 512x512 scene (24 train and 4 test views from
12,000 gaussians). The scene is written with `cli.make_synthetic` unless
`--scene` names one.

Each run counts K1's and K2's launches inside `Trainer.train` (a rank's
in its own process), which must equal its iterations, and over the
whole CLI run (`launches_run`; a rank also from its process's start,
`launches_process`). The kernels' arguments of the last iteration's
step are saved under the work directory, the single run's and each
rank's (`captures`), for a caller to hold the kernels to their plain
versions on them. Writes one JSON object to `--out` (default under
`build/`).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "convergence.json"
ANCHORS = re.compile(r"\[it\s*(\d+)\] .*anchors=(\d+)")


def anchors_from_log(model_path):
    """[(iteration, anchors)] of a run's progress lines."""
    path = os.path.join(model_path, "outputs.log")
    traj = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                m = ANCHORS.search(line)
                if m:
                    traj.append((int(m.group(1)), int(m.group(2))))
    return traj


def train_counted(argv, capture_it, capture_path):
    """`cli.train.main(argv)` with this process's K1/K2 launches counted
    -> its record: `launches` inside `Trainer.train` (once an iteration),
    `launches_run` over the whole CLI run (its evaluation renders too).
    The kernels' arguments of iteration `capture_it`'s step go to
    `capture_path` (`tools/mesh_check --capture`'s format)."""
    from horizongs_tpu_torch.cli.train import main as train_main
    from horizongs_tpu_torch.tools.mesh_check import (
        _Capture, _kernels, _launches)
    from horizongs_tpu_torch.train.trainer import Trainer
    kernels, names = _kernels("3D")
    runs = []
    orig, orig_step_fn = Trainer.train, Trainer._step_fn

    def train(self, *a, **kw):
        before = _launches(kernels)
        t0 = time.perf_counter()
        hist = orig(self, *a, **kw)
        if self.scene.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.scene.device)
        runs.append({"iterations": len(hist), "seconds":
                     time.perf_counter() - t0,
                     "launches": [x - y for x, y in
                                  zip(_launches(kernels), before)],
                     "densify_epochs": len(self.records["densify"]),
                     "overflows": len(self.records["overflows"]),
                     "loss_last": hist[-1]})
        return hist

    def step_fn(self, H, W):
        step = orig_step_fn(self, H, W)

        def captured(state, ct, it):
            if it != capture_it:
                return step(state, ct, it)
            import torch
            with _Capture(names) as cap:
                out = step(state, ct, it)
            torch.save({"gs": "3D", "names": names, "iteration": it,
                        "fwd": cap.calls[names[0]][0],
                        "bwd": cap.calls[names[1]][0]}, capture_path)
            return out
        return captured
    before = _launches(kernels)
    Trainer.train, Trainer._step_fn = train, step_fn
    try:
        rc = train_main(argv)
    finally:
        Trainer.train, Trainer._step_fn = orig, orig_step_fn
    return {"rc": rc, "rank": int(os.environ.get("RANK", 0)), **runs[-1],
            "launches_run": [x - y for x, y in
                             zip(_launches(kernels), before)]}


def _worker(out_dir, capture_it, *argv):
    """One rank of a launched run: its record in <out_dir>/rank<r>.json,
    with `launches_process`, its K1/K2 launches from the start of the
    process to its end; its captured step in <out_dir>/capture_rank<r>.pt
    of iteration `capture_it`."""
    from horizongs_tpu_torch.tools.mesh_check import _kernels, _launches
    rank = int(os.environ.get("RANK", 0))
    os.makedirs(out_dir, exist_ok=True)
    rec = train_counted(list(argv), int(capture_it),
                        os.path.join(out_dir, f"capture_rank{rank}.pt"))
    rec["launches_process"] = _launches(_kernels("3D")[0])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return rec["rc"]


def _result(label, model_path, ranks, seconds):
    with open(os.path.join(model_path, "results_test.json")) as f:
        results = json.load(f)
    psnr = results[next(iter(results))]["all"]["PSNR"]
    traj = anchors_from_log(model_path)
    r0 = ranks[0]
    print(f"{label}: test PSNR={psnr} final anchors="
          f"{traj[-1][1] if traj else None}, densify epochs "
          f"{r0['densify_epochs']}, {r0['iterations'] / r0['seconds']:.2f} "
          f"it/s", flush=True)
    return {"test_psnr": psnr, "anchor_trajectory": traj,
            "seconds": seconds, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=None,
                    help="2000 (2500 with --flagship) when omitted")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--mesh", default="1x2")
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal; the card when omitted")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if args.iterations is None:
        args.iterations = 2500 if args.flagship else 2000
    dev = ["--device", args.device] if args.device else []
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="hgs_conv_"))
    scene = args.scene or str(workdir / "scene")
    if not os.path.exists(scene):
        from horizongs_tpu_torch.cli.make_synthetic import main as mk
        size = (["--width", "512", "--height", "512", "--n_gauss", "12000"]
                if args.flagship else
                ["--width", "64", "--height", "64", "--n_gauss", "80"])
        mk([scene, "--n_train", "24", "--n_test", "4", *size, *dev])
    cfg = str(ROOT / "configs" / "synthetic" / (
        "flagship512.yaml" if args.flagship else "quickstart.yaml"))

    def cli_args(label):
        return ["--config", cfg, "--model_path", str(workdir / label),
                "--source_path", scene, "--iterations", str(args.iterations),
                "--disable_tb", *dev]

    t0 = time.perf_counter()
    captures = {"single": [str(workdir / "capture_single.pt")]}
    single = _result("single", str(workdir / "single"),
                     [train_counted(cli_args("single"), args.iterations,
                                    captures["single"][0])],
                     time.perf_counter() - t0)
    d, m = (int(x) for x in args.mesh.lower().split("x"))
    ranks_dir = workdir / "ranks_mesh"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(d * m), "-m",
         "horizongs_tpu_torch.tools.convergence_check", "--worker",
         str(ranks_dir), str(args.iterations), *cli_args("mesh"),
         "--mesh", args.mesh],
        env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the --mesh {args.mesh} run exited "
                           f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    ranks = [json.loads((ranks_dir / f"rank{r}.json").read_text())
             for r in range(d * m)]
    captures["mesh"] = [str(ranks_dir / f"capture_rank{r}.pt")
                        for r in range(d * m)]
    mesh = _result(f"mesh_{args.mesh}", str(workdir / "mesh"), ranks,
                   time.perf_counter() - t0)
    gap = abs(single["test_psnr"] - mesh["test_psnr"])
    n_s = single["anchor_trajectory"][-1][1]
    n_m = mesh["anchor_trajectory"][-1][1]
    # on the CPU the wrappers run the plain versions and count nothing
    launches_ok = None if args.device == "cpu" else all(
        r["launches"] == [r["iterations"]] * 2
        for r in single["ranks"] + mesh["ranks"])
    out = {"device": _device_name(args.device), "config": os.path.relpath(
        cfg, ROOT), "iterations": args.iterations, "mesh": args.mesh,
        "single": single, f"mesh_{args.mesh}": mesh, "psnr_gap_db": gap,
        "anchors_final": {"single": n_s, "mesh": n_m},
        "anchors_rel_diff": abs(n_s - n_m) / max(n_s, 1),
        "densify_epochs": {"single": single["ranks"][0]["densify_epochs"],
                           "mesh": mesh["ranks"][0]["densify_epochs"]},
        "launches_once_per_iteration": launches_ok,
        "captures": captures}
    print(f"PSNR gap (single vs {args.mesh}): {gap:.4f} dB; anchors single="
          f"{n_s} mesh={n_m}; densify epochs {out['densify_epochs']}",
          flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {os.path.relpath(args.out)}", flush=True)
    return 0


def _device_name(device):
    import torch
    if device == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        raise SystemExit(_worker(*sys.argv[2:]))
    raise SystemExit(main())
