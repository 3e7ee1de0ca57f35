"""`python -m horizongs_tpu_torch.cli.render -m PATH`: render the train and
test sets of a trained model on the card (`--device cpu` for the CPU).

The JAX package's `cli/render.py` (the reference's `render.py -m PATH
[--explicit]`, `render.py:176-219`): each set through
`train.evaluate.render_set` into `<PATH>/{train,test}/ours_<it>/`, the
neural model through K1 (K3 for 2DGS) or with `--explicit` the baked
model through K1, and with `--path_video` an elliptical fly-through whose
PNG frames (and an mp4 where `imageio` is installed) go to
`<PATH>/path_frames/` (`path.mp4`).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Render train/test sets")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--explicit", action="store_true")
    parser.add_argument("--rasterizer", default="cuda",
                        choices=["cuda", "dense"])
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    parser.add_argument("--path_video", action="store_true",
                        help="render an elliptical fly-through + video "
                        "(reference utils/render_utils.py path)")
    parser.add_argument("--path_frames", type=int, default=120)
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.cli.common import get_logger, load_config
    from horizongs_tpu_torch.data.scene import Scene
    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.train.evaluate import render_set
    from horizongs_tpu_torch.utils.render_paths import (
        generate_path_cameras, write_video)

    device = resolve_device(args.device)
    lp, op, pp, cfg = load_config(
        os.path.join(args.model_path, "config.yaml"), args.model_path)
    logger = get_logger("render", args.model_path)
    scene = Scene(lp, cfg, load_iteration=args.iteration,
                  explicit=args.explicit, logger=logger, device=device)
    state = scene.explicit_state if args.explicit else scene.train_state
    kw = dict(rasterizer=args.rasterizer, explicit=args.explicit)
    # the sets with the prefilter off iff training switched it off at the
    # end (`train.py:478-484`); the fly-through with the scene's default
    prefilter = not (int(getattr(pp, "no_prefilter_step", 0) or 0) > 0)

    for name, cams, skip in (
            ("train", scene.get_train_cameras(), args.skip_train),
            ("test", scene.get_test_cameras(), args.skip_test)):
        if skip or not cams:
            continue
        logger.info(f"Rendering {name} set ({len(cams)} views)")
        _, _, counts, times, _, _ = render_set(
            args.model_path, name, scene.loaded_iter, cams, scene.cfg,
            scene, state, add_prefilter=prefilter, **kw)
        fps = len(times) / max(sum(times), 1e-9)
        logger.info(f"{name}: {fps:.2f} views/s, "
                    f"mean visible GS {sum(counts) / len(counts):.0f}")

    if args.path_video:
        path_cams = generate_path_cameras(scene.get_train_cameras(),
                                          n_frames=args.path_frames)
        logger.info(f"Rendering fly-through ({len(path_cams)} frames)")
        renders, *_ = render_set(
            args.model_path, "path", scene.loaded_iter, path_cams,
            scene.cfg, scene, state, save_images=False, **kw)
        out = write_video([r[..., :3] for r in renders],
                          os.path.join(args.model_path, "path.mp4"))
        logger.info(f"fly-through written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
