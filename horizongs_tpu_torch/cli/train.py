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
iteration 20 into <model_path>/profile/, and `--detect_anomaly` turns on
`torch.autograd.set_detect_anomaly` (the reference's `train.py:760`).

Not ported yet, each refused with an error naming its queue of
ROADMAP.md: the multi-device options (`--mesh`, `--band_cap`,
`--balanced_bands`, `--uniform_bands`, `--no_balanced_batches`,
`--checkpoint_format sharded`; queue 3).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

# options of the JAX CLI not ported yet -> the ROADMAP.md queue that
# brings them; the flags among them take no value
_NOT_PORTED = {
    "mesh": 3, "band_cap": 3, "balanced_bands": 3, "uniform_bands": 3,
    "no_balanced_batches": 3,
}
_FLAGS = ("balanced_bands", "uniform_bands", "no_balanced_batches")


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
                        choices=["cuda", "dense"])
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    parser.add_argument("--skip_eval", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--disable_tb", action="store_true",
                        help="skip tensorboard SummaryWriter creation")
    parser.add_argument("--viewer_port", type=int, default=None,
                        help="poll a SIBR remote-GUI client during training "
                        "(reference network_gui, shipped disabled there)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="write a torch.profiler trace of N training "
                        "iterations, from iteration 20, into "
                        "<model_path>/profile/")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly: the "
                        "backward names the forward op behind a NaN (the "
                        "reference's train.py:760; slow, for debugging)")
    parser.add_argument("--checkpoint_format", default="npz",
                        choices=["npz", "sharded"],
                        help="npz (one file); sharded is not ported yet "
                        "(ROADMAP queue 3)")
    for name, queue in _NOT_PORTED.items():
        kw = (dict(action="store_true") if name in _FLAGS
              else dict(default=None))
        parser.add_argument(f"--{name}", help=f"not ported yet (ROADMAP "
                            f"queue {queue})", **kw)
    args = parser.parse_args(argv)
    refused = [f"--{n} (ROADMAP.md queue {q})"
               for n, q in _NOT_PORTED.items()
               if getattr(args, n) not in (None, False, "0")]
    if args.checkpoint_format == "sharded":
        refused.append("--checkpoint_format sharded (ROADMAP.md queue 3)")
    if refused:
        raise NotImplementedError(
            "not ported to horizongs_tpu_torch yet: " + ", ".join(refused))

    import torch
    import yaml

    from horizongs_tpu_torch.cli.common import get_logger, load_config
    from horizongs_tpu_torch.config import load_yaml
    from horizongs_tpu_torch.data.scene import Scene
    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.train.evaluate import (
        evaluate_sets, lpips_fn_or_none, render_set)
    from horizongs_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    lp, op, pp, cfg = load_config(args.config, args.model_path)
    if args.source_path is not None:
        lp.source_path = args.source_path
    if args.iterations is not None:
        op.iterations = args.iterations
    logger = get_logger("train", lp.model_path)
    os.makedirs(lp.model_path, exist_ok=True)
    # the RESOLVED config, so that later runs on this directory see the
    # command line's overrides
    raw = load_yaml(args.config)
    raw.setdefault("model_params", {})["source_path"] = lp.source_path
    raw["model_params"]["model_path"] = lp.model_path
    if args.iterations is not None:
        raw.setdefault("optim_params", {})["iterations"] = op.iterations
    with open(os.path.join(lp.model_path, "config.yaml"), "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    with open(os.path.join(lp.model_path, "cfg_args"), "w") as f:
        f.write(str(vars(lp)))
    # source snapshot for debugging afterwards (`saveRuntimeCode`,
    # reference `train.py:60-81,735`)
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(lp.model_path, "backup", "horizongs_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(pkg_dir, dst,
                        ignore=shutil.ignore_patterns("__pycache__"))

    tb_writer = None
    if not args.disable_tb:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(lp.model_path)
        except Exception as e:
            logger.info(f"tensorboard unavailable: {e}")

    scene = Scene(lp, cfg, weed_ratio=pp.weed_ratio, logger=logger,
                  seed=args.seed, device=device)
    trainer = Trainer(scene.cfg, op, pp, scene, logger=logger,
                      rasterizer=args.rasterizer, seed=args.seed,
                      tb_writer=tb_writer, viewer_port=args.viewer_port,
                      profile_steps=(20, args.profile) if args.profile
                      else None)
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

    if not args.skip_eval:
        logger.info("Rendering + evaluating test set")
        cams = scene.get_test_cameras() or scene.get_train_cameras()
        renders, gts, counts, times, types, subsets = render_set(
            lp.model_path, "test", iterations, cams, scene.cfg, scene,
            trainer.state, rasterizer=trainer.rasterizer,
            # reference render_sets: prefilter off iff no_prefilter_step
            # was used in training (`train.py:478-484`)
            add_prefilter=not (int(getattr(pp, "no_prefilter_step", 0)
                                   or 0) > 0))
        results = evaluate_sets(lp.model_path, iterations, renders, gts,
                                types, lpips_model=lpips_fn_or_none(device),
                                subsets=subsets, device=device)
        logger.info(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
