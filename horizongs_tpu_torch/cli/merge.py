"""`python -m horizongs_tpu_torch.cli.merge -m ROOT --source_path DATA`:
merge trained chunk models into one explicit scene and, with
`--eval_config`, evaluate it (the JAX package's `cli/merge.py`, the
reference's `merge.py`).

The merge (`parallel.chunks.consolidate_chunks`) is host numpy and writes
`<ROOT>/merged_model/point_cloud/iteration_<N>/point_cloud_explicit.ply`
from `<ROOT>/<chunk_stage>/<id>`. The evaluation loads that model with
`Scene(explicit=True)` on the card (`--device cpu` for the CPU), renders
the config's test views through K1 (`--rasterizer cuda`, calibrated,
nothing dropped) or the dense oracle, and writes results_test.json.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge trained chunk models into one explicit scene")
    parser.add_argument("-m", "--model_path", required=True,
                        help="root containing chunk_fine/<id> model dirs")
    parser.add_argument("--source_path", required=True,
                        help="dataset root containing chunks/partitions.json")
    parser.add_argument("--chunk_stage", default="chunk_fine")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--eval_config", default=None,
                        help="config YAML for re-render + eval of the merge")
    parser.add_argument("--rasterizer", default="cuda",
                        choices=["cuda", "dense"])
    parser.add_argument("--device", default=None,
                        help="where the evaluation runs: the card when "
                        "omitted (raises without one), or cpu")
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.config import load_yaml
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.parallel.chunks import consolidate_chunks

    with open(os.path.join(args.source_path, "chunks",
                           "partitions.json")) as f:
        meta = json.load(f)

    chunk_dirs = {}
    for cid in meta["chunks"]:
        d = os.path.join(args.model_path, args.chunk_stage, cid)
        if os.path.isdir(d):
            chunk_dirs[cid] = d
    if not chunk_dirs:
        raise FileNotFoundError(
            f"no chunk model dirs under {args.model_path}/{args.chunk_stage}")

    # model config from the first chunk's saved config
    first = next(iter(chunk_dirs.values()))
    cfg_file = os.path.join(first, "config.yaml")
    if os.path.exists(cfg_file):
        cfg = ModelConfig.from_dict(
            load_yaml(cfg_file)["model_params"]["model_config"])
    else:
        cfg = ModelConfig()

    merged_dir = os.path.join(args.model_path, "merged_model")
    path = consolidate_chunks(chunk_dirs, meta, merged_dir, cfg,
                              scale=args.scale)
    print(f"merged explicit scene -> {path}")

    if args.eval_config:
        from horizongs_tpu_torch.cli.common import get_logger, load_config
        from horizongs_tpu_torch.data.scene import Scene
        from horizongs_tpu_torch.device import resolve_device
        from horizongs_tpu_torch.train.evaluate import (
            evaluate_sets, lpips_fn_or_none, render_set)
        device = resolve_device(args.device)
        lp, op, pp, mcfg = load_config(args.eval_config, merged_dir)
        logger = get_logger("merge", merged_dir)
        scene = Scene(lp, mcfg, load_iteration=-1, explicit=True,
                      logger=logger, device=device)
        cams = scene.get_test_cameras() or scene.get_train_cameras()
        renders, gts, counts, times, types, subsets = render_set(
            merged_dir, "test", scene.loaded_iter, cams, scene.cfg, scene,
            scene.explicit_state, rasterizer=args.rasterizer, explicit=True)
        results = evaluate_sets(merged_dir, scene.loaded_iter, renders, gts,
                                types, lpips_model=lpips_fn_or_none(device),
                                subsets=subsets, device=device)
        print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
