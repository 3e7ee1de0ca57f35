"""`python -m horizongs_tpu_torch.cli.train --config X.yaml`: the train
entry point, on the card (`--device cpu` for the CPU).

The JAX package's `cli/train.py` (the reference's `python train.py
--config X.yaml`, `train.py:689-779`): load the dataset and build the
scene, train (coarse from the point cloud, or fine from the config's
`pretrained_checkpoint`), save, write checkpoints, resume from one with
`--start_checkpoint`, then re-render the test set and write
results_test.json. The run's directory gets the resolved config.yaml,
cfg_args and a copy of this package's source under backup/.
`--viewer_port` serves the model being trained to a viewer client,
`--profile N` writes a `torch.profiler` trace of N iterations from
iteration 20 into <model_path>/profile/trace.json and, beside it,
profile/spans.json: the port's spans of those iterations
(`horizongs_tpu_torch.tracing`: `trainer.*`, `step.forward` /
`backward` / `update`, `render.decode` / `bin` / `composite`, each
with its iteration, parent, host ms and CUDA-event device ms) and its
counters. `--detect_anomaly` turns on
`torch.autograd.set_detect_anomaly` (the reference's `train.py:760`).
`--wandb` logs to a wandb run (project "horizongs_tpu", rank 0) when the
`wandb` package imports; without it the run logs "wandb unavailable" and
trains on.

Several ranks train one scene over a data x model mesh (`--mesh DxM`,
`parallel/step.py`), one process a rank, launched with

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m horizongs_tpu_torch.cli.train --mesh DxM --config X.yaml ...

Each rank takes `cuda:(LOCAL_RANK % cards)`; the backend is NCCL when every
rank has a card of its own and gloo when ranks share one or run on the CPU
(`--device cpu`). Rank 0 alone writes the run's files. Checkpoints are
sharded directories under a mesh unless `--checkpoint_format npz`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil


# the JAX CLI's compositing backends, each the port's cuda path
JAX_RASTERIZERS = ("auto", "pallas", "tiled", "pallas_interpret")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a Horizon-GS model on the card")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--source_path", default=None,
                        help="override model_params.source_path")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--save_iterations", type=int, nargs="*",
                        default=None)
    parser.add_argument("--test_iterations", type=int, nargs="*", default=[],
                        help="in-train milestone evaluation iterations "
                        "(reference training_report, train.py:309-383)")
    parser.add_argument("--checkpoint_iterations", type=int, nargs="*",
                        default=[])
    parser.add_argument("--start_checkpoint", default=None,
                        help="chkpnt{N}.npz (of either package) to resume "
                        "from")
    parser.add_argument("--rasterizer", default="cuda",
                        choices=["cuda", "dense", *JAX_RASTERIZERS],
                        help="cuda (K1-K4; their plain versions on the "
                        "CPU) or dense; the JAX CLI's auto, pallas, tiled "
                        "and pallas_interpret name the compositing path, "
                        "here cuda")
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wandb", action="store_true",
                        help="log to a wandb run (when wandb imports)")
    parser.add_argument("--disable_tb", action="store_true",
                        help="skip tensorboard SummaryWriter creation")
    parser.add_argument("--viewer_port", type=int, default=None,
                        help="poll a SIBR remote-GUI client during training "
                        "(reference network_gui, shipped disabled there)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="write a torch.profiler trace of N training "
                        "iterations, from iteration 20, and the port's "
                        "spans of them into <model_path>/profile/ "
                        "(trace.json, spans.json)")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly: the "
                        "backward names the forward op behind a NaN (the "
                        "reference's train.py:760; slow, for debugging)")
    parser.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                        help="train over a data x model mesh of the "
                        "launched ranks, e.g. '1x2' (cameras data-parallel "
                        "x anchor rows and image bands), or 'auto'")
    parser.add_argument("--band_cap", type=int, default=None,
                        help="record slots per (source rank, band) of the "
                        "band exchange (default: calibrated on sample "
                        "views; an overflow is counted and recalibrated)")
    parser.add_argument("--balanced_bands", action="store_true",
                        default=None,
                        help="cut the bands at equal routed-record "
                        "quantiles of sample views instead of uniformly")
    parser.add_argument("--uniform_bands", action="store_true",
                        help="uniform bands (overrides --balanced_bands)")
    parser.add_argument("--no_balanced_batches", action="store_true",
                        help="fill each data-parallel batch at random "
                        "instead of with views of the nearest cost")
    parser.add_argument("--checkpoint_format", default=None,
                        choices=["npz", "sharded"],
                        help="npz (one file, gathered) or sharded (a "
                        "directory, each rank its rows); sharded under "
                        "--mesh, npz otherwise")
    args = parser.parse_args(argv)
    if args.rasterizer in JAX_RASTERIZERS:
        args.rasterizer = "cuda"

    import torch
    import torch.distributed as dist

    from horizongs_tpu_torch.cli.common import get_logger, load_config
    from horizongs_tpu_torch.data.scene import Scene
    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.parallel.mesh import (
        maybe_init_distributed, parse_mesh_spec)
    from horizongs_tpu_torch.train.evaluate import (
        evaluate_sets, lpips_fn_or_none, render_set)
    from horizongs_tpu_torch.train.trainer import Trainer

    # the process group first: the mesh's groups and every collective need
    # it, and the rank decides which process writes files
    started = False
    if args.mesh:
        started = not dist.is_initialized()
        maybe_init_distributed(device=args.device)
    mesh = parse_mesh_spec(args.mesh, device=args.device)
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if args.checkpoint_format is None:
        args.checkpoint_format = "sharded" if mesh is not None else "npz"
    lp, op, pp, cfg = load_config(args.config, args.model_path)
    if args.source_path is not None:
        lp.source_path = args.source_path
    if args.iterations is not None:
        op.iterations = args.iterations
    logger = get_logger("train", lp.model_path if main_rank else None)
    if mesh is not None:
        logger.info(f"training mesh: data={mesh.shape['data']} x "
                    f"model={mesh.shape['model']}, {mesh}")
    if main_rank:
        _write_run_files(args, lp, op)

    wandb_run = None
    if args.wandb and main_rank:
        try:
            import wandb
            wandb_run = wandb.init(project="horizongs_tpu",
                                   name=str(lp.scene_name), config=vars(op))
        except Exception as e:      # no package, no login, no network
            logger.info(f"wandb unavailable: {e}")

    tb_writer = None
    if not args.disable_tb and main_rank:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(lp.model_path)
        except Exception as e:
            logger.info(f"tensorboard unavailable: {e}")

    scene = Scene(lp, cfg, weed_ratio=pp.weed_ratio, logger=logger,
                  seed=args.seed, device=device, write_files=main_rank)
    trainer = Trainer(scene.cfg, op, pp, scene, logger=logger,
                      rasterizer=args.rasterizer, seed=args.seed,
                      tb_writer=tb_writer, viewer_port=args.viewer_port,
                      profile_steps=(20, args.profile) if args.profile
                      else None,
                      mesh=mesh, band_cap=args.band_cap,
                      checkpoint_format=args.checkpoint_format,
                      balanced_bands=(False if args.uniform_bands
                                      else args.balanced_bands),
                      balanced_batches=(False if args.no_balanced_batches
                                        else None),
                      wandb_run=wandb_run)
    iterations = op.iterations
    save_iters = set(args.save_iterations
                     if args.save_iterations is not None else [iterations])
    save_iters.add(iterations)
    first_iter = 1
    if args.start_checkpoint:
        ckpt_it = trainer.restore(args.start_checkpoint)
        first_iter = ckpt_it + 1
        logger.info(f"Resumed from {args.start_checkpoint} "
                    f"at iteration {ckpt_it}")
    # anomaly mode for the training run only, restored after it
    with torch.autograd.set_detect_anomaly(args.detect_anomaly):
        trainer.train(iterations=iterations, save_iterations=save_iters,
                      checkpoint_iterations=set(args.checkpoint_iterations),
                      test_iterations=set(args.test_iterations),
                      first_iter=first_iter)
    if trainer.viewer is not None:
        trainer.viewer.close()
    if tb_writer is not None:
        tb_writer.close()   # flush buffered scalars

    host = trainer._host_state() if not args.skip_eval else None
    if not args.skip_eval and main_rank:
        logger.info("Rendering + evaluating test set")
        cams = scene.get_test_cameras() or scene.get_train_cameras()
        renders, gts, counts, times, types, subsets = render_set(
            lp.model_path, "test", iterations, cams, scene.cfg, scene,
            host, rasterizer=trainer.rasterizer,
            # reference render_sets: prefilter off iff no_prefilter_step
            # was used in training (`train.py:478-484`)
            add_prefilter=not (int(getattr(pp, "no_prefilter_step", 0)
                                   or 0) > 0))
        results = evaluate_sets(lp.model_path, iterations, renders, gts,
                                types, lpips_model=lpips_fn_or_none(device),
                                subsets=subsets, device=device)
        logger.info(json.dumps(results, indent=2))
    if mesh is not None and dist.is_initialized():
        dist.barrier()
        if started:
            dist.destroy_process_group()
    return 0


def _write_run_files(args, lp, op) -> None:
    """The run directory's resolved config.yaml (the command line's
    overrides included, for later runs on the directory), cfg_args and a
    copy of this package's source under backup/ (`saveRuntimeCode`,
    reference `train.py:60-81,735`)."""
    import yaml

    from horizongs_tpu_torch.config import load_yaml
    os.makedirs(lp.model_path, exist_ok=True)
    raw = load_yaml(args.config)
    raw.setdefault("model_params", {})["source_path"] = lp.source_path
    raw["model_params"]["model_path"] = lp.model_path
    if args.iterations is not None:
        raw.setdefault("optim_params", {})["iterations"] = op.iterations
    with open(os.path.join(lp.model_path, "config.yaml"), "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    with open(os.path.join(lp.model_path, "cfg_args"), "w") as f:
        f.write(str(vars(lp)))
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(lp.model_path, "backup", "horizongs_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(pkg_dir, dst,
                        ignore=shutil.ignore_patterns("__pycache__"))


if __name__ == "__main__":
    raise SystemExit(main())
