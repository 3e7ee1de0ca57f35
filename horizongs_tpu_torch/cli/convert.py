"""`python -m horizongs_tpu_torch.cli.convert -s PATH`: the COLMAP SfM
wrapper, a copy of the JAX package's `cli/convert.py` (the reference's
`preprocess/convert.py`: feature extraction -> matching -> mapper ->
undistort [-> resized copies with PIL]). It needs the external `colmap`
binary, checked up front: without it, it says so and returns 1. It runs
nothing on the card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def _run(cmd, logger) -> None:
    logger.info("$ " + " ".join(cmd))
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"command failed ({proc.returncode}): {cmd[0]}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run COLMAP SfM")
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="colmap")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--resize", action="store_true",
                        help="also write images_2/4/8 downsampled copies")
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.cli.common import get_logger
    logger = get_logger("convert", args.source_path)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        logger.info(f"colmap binary not found ({colmap!r}); install COLMAP "
                    "or point --colmap_executable at it")
        return 1
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _run([colmap, "feature_extractor",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--image_path", os.path.join(src, "input"),
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", args.camera,
              "--SiftExtraction.use_gpu", use_gpu], logger)
        _run([colmap, "exhaustive_matcher",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--SiftMatching.use_gpu", use_gpu], logger)
        _run([colmap, "mapper",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--image_path", os.path.join(src, "input"),
              "--output_path", os.path.join(src, "distorted", "sparse"),
              "--Mapper.ba_global_function_tolerance=0.000001"], logger)

    _run([colmap, "image_undistorter",
          "--image_path", os.path.join(src, "input"),
          "--input_path", os.path.join(src, "distorted", "sparse", "0"),
          "--output_path", src, "--output_type", "COLMAP"], logger)

    # move sparse model into sparse/0 (reference convert.py layout)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f),
                        os.path.join(sparse, "0", f))

    if args.resize:
        from PIL import Image
        for scale, sub in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            out = os.path.join(src, sub)
            os.makedirs(out, exist_ok=True)
            for name in os.listdir(os.path.join(src, "images")):
                im = Image.open(os.path.join(src, "images", name))
                im.resize((im.width // scale, im.height // scale),
                          Image.LANCZOS).save(os.path.join(out, name))
    logger.info("COLMAP conversion done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
