"""`python -m horizongs_tpu_torch.cli.partition --config X.yaml`: chunk a
large scene and write the per-chunk configs (the JAX package's
`cli/partition.py`; reference `preprocess/data_preprocess.py` +
`generate_chunks_config.py`).

Host numpy in both packages, no device: the config's `data_params` name
the dataset (`source_path`, `data_format`, `eval`, `ratio` decimation,
`xyz_plane`, `n_width` x `n_height`, `overlap_area`, `visible_rate`), the
chunks go to `<source_path>/chunks/` (points3d.ply, transforms.json with
the frames of `transforms_train.json` or `transforms.json`,
partitions.json), the LOD parameters estimated from the cameras go into
`model_config.kwargs`, and the chunk configs (`chunk_coarse/`,
`chunk_fine/`, `global.yaml` when `appearance_dim` > 0) beside the config;
with `partition: false` a single scene's `coarse.yaml` / `fine.yaml`.
Every file is the one the JAX CLI writes, byte for byte."""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="YAML with data_params (+ optional base "
                        "optim/pipeline blocks for chunk configs)")
    args = parser.parse_args(argv)

    import yaml
    import numpy as np
    from horizongs_tpu_torch.config import load_yaml, make_model_params
    from horizongs_tpu_torch.data.partition import (
        CamGeom, estimate_lod_params, run_partition)
    from horizongs_tpu_torch.data.readers import scene_load_callbacks
    from horizongs_tpu_torch.parallel.chunks import generate_chunk_configs

    raw = load_yaml(args.config)
    dp = dict(raw.get("data_params", {}))
    fmt = dp.get("data_format", "city")
    loader = scene_load_callbacks[fmt]
    scene_info = loader(
        dp["source_path"], eval=dp.get("eval", False),
        add_mask=False, add_depth=dp.get("add_depth", False),
        add_aerial=dp.get("add_aerial", True),
        add_street=dp.get("add_street", True),
        center=dp.get("center", [0, 0, 0]), scale=dp.get("scale", 1.0),
        llffhold=dp.get("llffhold", 32), images=dp.get("images", "images"))

    pcd = scene_info.point_cloud
    ratio = int(dp.get("ratio", 1))
    if ratio > 1:
        pcd.points = pcd.points[::ratio]
        pcd.colors = pcd.colors[::ratio]
        pcd.normals = pcd.normals[::ratio]
    infos = scene_info.train_cameras

    plane = tuple(i for i, v in enumerate(dp.get("xyz_plane", [1, 1, 0]))
                  if v == 1)
    assert len(plane) == 2

    frames = None
    for tf_name in ("transforms_train.json", "transforms.json"):
        tf = os.path.join(dp["source_path"], tf_name)
        if os.path.exists(tf):
            with open(tf) as f:
                content = json.load(f)
            frames = sorted(content["frames"], key=lambda x: x["file_path"])
            for fr in frames:
                fr.setdefault("camera_angle_x",
                              content.get("camera_angle_x"))
            break

    chunks_dir = os.path.join(dp["source_path"], "chunks")
    if dp.get("partition", True):
        run_partition(pcd, infos, dp.get("n_width", 2), dp.get("n_height", 2),
                      chunks_dir, source_path=dp["source_path"],
                      overlap_area=dp.get("overlap_area", 0.1),
                      visible_rate=dp.get("visible_rate", 0.25),
                      plane=plane, frames=frames)
        print(f"partitioned into {dp.get('n_width', 2)}x"
              f"{dp.get('n_height', 2)} chunks under {chunks_dir}")

    # LOD estimation for LoD models (`data_preprocess.py:569-611`)
    model_config = dict(dp.get("model_config",
                               {"name": "GaussianLoDModel", "kwargs": {}}))
    if model_config.get("name") == "GaussianLoDModel":
        center = np.asarray(dp.get("center", [0, 0, 0]), dtype=np.float64)
        scale = float(dp.get("scale", 1.0))
        pts = (pcd.points - center) / scale
        cams = [CamGeom(i, idx) for idx, i in enumerate(infos)]
        for c in cams:
            c.center = (c.center - center) / scale
        lod = estimate_lod_params(
            pts, cams, model_config["kwargs"].get("fork", 2),
            dist_ratio=dp.get("dist_ratio", 0.9),
            aerial_lod=dp.get("aerial_lod", "multi"),
            street_lod=dp.get("street_lod", "multi"))
        model_config["kwargs"].update(lod)
        print(f"estimated LOD params: {lod}")

    base_mp = dict(make_model_params().__dict__)
    base_mp.update({k: v for k, v in dp.items()
                    if k in base_mp})
    base_mp["model_config"] = model_config

    if dp.get("partition", True):
        generate_chunk_configs(
            os.path.dirname(os.path.abspath(args.config)), base_mp,
            raw.get("chunk_coarse", raw), raw.get("chunk_fine", raw),
            chunks_dir, dp.get("n_width", 2), dp.get("n_height", 2),
            dp.get("dataset_name", "scene"), dp.get("scene_name", "scene"),
            global_yaml=raw.get("global") if
            model_config["kwargs"].get("appearance_dim", 0) > 0 else None)
        print("chunk configs written")
    else:
        # single-scene coarse/fine configs (`generate_config.py`)
        out_dir = os.path.dirname(os.path.abspath(args.config))
        for stage, overrides in (("coarse", raw.get("coarse", raw)),
                                 ("fine", raw.get("fine", raw))):
            mp = dict(base_mp)
            mp["scene_name"] = f"{dp.get('scene_name', 'scene')}/{stage}"
            if stage == "fine":
                mp["pretrained_checkpoint"] = os.path.join(
                    "outputs", str(dp.get("dataset_name", "scene")),
                    str(dp.get("scene_name", "scene")), "coarse")
            cfg = {"model_params": mp,
                   "pipeline_params": overrides.get("pipeline_params", {}),
                   "optim_params": overrides.get("optim_params", {})}
            with open(os.path.join(out_dir, f"{stage}.yaml"), "w") as f:
                yaml.dump(cfg, f)
        print("coarse.yaml / fine.yaml written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
