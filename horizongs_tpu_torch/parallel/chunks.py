"""Chunk-level scale-out: config generation, orchestration, merge.

The JAX package's `parallel/chunks.py`, which replaces the reference's
manual per-chunk workflow (`README.md:64-78`: run train.py once per
generated chunk config, then `merge.py`):
  * `generate_chunk_configs` stamps coarse/fine YAMLs per chunk
    (`preprocess/generate_chunks_config.py:50-104` semantics, incl. the
    optional global-appearance pretrain stage); the same bytes as the JAX
    package's
  * `train_chunks` runs the chunk jobs through this package's train CLI,
    on the card unless the extra arguments say `--device cpu`: in-process
    one after another, or one subprocess per job (`parallel=N`; several
    jobs on one card are the caller's choice); with `n_hosts` > 1 each
    host takes the jobs whose index i has i % n_hosts == host_id
  * `consolidate_chunks` merges the per-chunk baked explicit PLYs,
    cropping each to its true (non-overlapping) bounds (`merge.py:55-217`);
    host numpy, file-bound, and the merged PLY equals the JAX merge's byte
    for byte
"""
from __future__ import annotations

import copy
import dataclasses
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

from horizongs_tpu_torch.io.checkpoints import (
    explicit_ply_props,
    load_explicit_ply,
    search_max_iteration,
)
from horizongs_tpu_torch.io.plyio import PlyStreamWriter
from horizongs_tpu_torch.models.config import ModelConfig


def generate_chunk_configs(config_dir: str, base_model_params: dict,
                           coarse_overrides: dict, fine_overrides: dict,
                           chunks_dir: str, n_width: int, n_height: int,
                           dataset_name: str, scene_name: str,
                           global_yaml: Optional[dict] = None) -> List[str]:
    """Write chunk_coarse/{m}_{n}.yaml + chunk_fine/{m}_{n}.yaml; returns
    their paths, coarse then fine for each chunk. A fine config's
    `pretrained_checkpoint` names its coarse model directory, which the
    fine stage's `Scene` resolves to its last saved iteration."""
    import yaml
    coarse_dir = os.path.join(config_dir, "chunk_coarse")
    fine_dir = os.path.join(config_dir, "chunk_fine")
    os.makedirs(coarse_dir, exist_ok=True)
    os.makedirs(fine_dir, exist_ok=True)
    paths = []
    global_appearance = ""
    if global_yaml is not None:
        g = copy.deepcopy(global_yaml)
        g.setdefault("model_params", {}).update(base_model_params)
        g["model_params"]["scene_name"] = f"{scene_name}/global"
        with open(os.path.join(config_dir, "global.yaml"), "w") as f:
            yaml.dump(g, f)
        global_appearance = os.path.join("outputs", dataset_name,
                                         scene_name, "global")
    for m in range(n_width):
        for n in range(n_height):
            cid = f"{m}_{n}"
            src = os.path.join(chunks_dir, cid)
            mp_coarse = dict(base_model_params)
            mp_coarse.update(
                source_path=src, data_format="city", eval=False,
                llffhold=32, global_appearance=global_appearance,
                scene_name=f"{scene_name}/chunk_coarse/{cid}")
            cfg_c = {"model_params": mp_coarse,
                     "pipeline_params": coarse_overrides.get("pipeline_params", {}),
                     "optim_params": coarse_overrides.get("optim_params", {})}
            pc = os.path.join(coarse_dir, cid + ".yaml")
            with open(pc, "w") as f:
                yaml.dump(cfg_c, f)

            mp_fine = dict(mp_coarse)
            mp_fine.update(
                scene_name=f"{scene_name}/chunk_fine/{cid}",
                pretrained_checkpoint=os.path.join(
                    "outputs", dataset_name, scene_name,
                    "chunk_coarse", cid))
            cfg_f = {"model_params": mp_fine,
                     "pipeline_params": fine_overrides.get("pipeline_params", {}),
                     "optim_params": fine_overrides.get("optim_params", {})}
            pf = os.path.join(fine_dir, cid + ".yaml")
            with open(pf, "w") as f:
                yaml.dump(cfg_f, f)
            paths.extend([pc, pf])
    return paths


def train_chunks(config_paths: List[str], model_paths: List[str],
                 extra_args: Optional[List[str]] = None,
                 parallel: int = 0, host_id: int = 0,
                 n_hosts: int = 1) -> None:
    """Train `config_paths[i]` into `model_paths[i]` for this host's jobs.
    `parallel` <= 1 runs them in this process in order (so a fine config
    may follow its coarse one); otherwise at most `parallel` subprocesses
    of `python -m horizongs_tpu_torch.cli.train` run at once, and jobs
    that depend on each other belong in separate calls. `extra_args` go to
    every job (e.g. `--device cpu`). A failed job raises RuntimeError."""
    jobs = [(c, m) for i, (c, m) in enumerate(zip(config_paths, model_paths))
            if i % n_hosts == host_id]
    extra = list(extra_args or [])
    if parallel <= 1:
        from horizongs_tpu_torch.cli.train import main as train_main
        for cfg, mp in jobs:
            rc = train_main(["--config", cfg, "--model_path", mp] + extra)
            if rc != 0:
                raise RuntimeError(f"chunk job {cfg} returned {rc}")
        return
    # the subprocesses import this package from the checkout it lies in,
    # whatever their working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs: List[subprocess.Popen] = []
    try:
        for cfg, mp in jobs:
            while sum(p.poll() is None for p in procs) >= parallel:
                next(p for p in procs if p.poll() is None).wait()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horizongs_tpu_torch.cli.train",
                 "--config", cfg, "--model_path", mp] + extra, env=env))
    finally:
        for p in procs:
            p.wait()
    failed = [p.args for p in procs if p.returncode != 0]
    if failed:
        raise RuntimeError(f"chunk jobs failed: {failed}")


def consolidate_chunks(chunk_model_dirs: Dict[str, str],
                       partitions_meta: dict, merged_dir: str,
                       cfg: ModelConfig, scale: float = 1.0,
                       plane=(0, 1)) -> str:
    """Merge per-chunk explicit PLYs -> one explicit PLY, STREAMING:
    two passes over the chunks (count, then crop-and-append), so peak
    memory is one chunk's arrays — at Block_A scale (8 chunks x millions
    of explicit gaussians) the reference's all-in-RAM concat
    (`merge.py:55-217`) costs GBs; this is bounded by the largest chunk.

    chunk_model_dirs: {chunk_id: model_path of the trained chunk}, merged
    in this order; `obj_info` comes from the last chunk."""
    px, py = plane

    def _load(cid: str, mdir: str):
        pc_dir = os.path.join(mdir, "point_cloud")
        it = search_max_iteration(pc_dir)
        if it < 0:
            raise FileNotFoundError(f"no saved iterations under {pc_dir}")
        arrays, info = load_explicit_ply(
            os.path.join(pc_dir, f"iteration_{it}",
                         "point_cloud_explicit.ply"))
        xb, yb = partitions_meta["chunks"][cid]["true_bounds"]
        xyz = arrays["xyz"]
        mask = ((xyz[:, px] >= xb[0] / scale)
                & (xyz[:, px] <= xb[1] / scale)
                & (xyz[:, py] >= yb[0] / scale)
                & (xyz[:, py] <= yb[1] / scale))
        return arrays, mask, info, it

    # pass 1: per-chunk cropped row counts + a shape fingerprint (one
    # chunk resident at a time). The schema itself is derived ONCE from
    # a 1-row sample of the first chunk — running the full
    # explicit_ply_props feature transpose per chunk here would double
    # the merge's CPU work for values pass 2 recomputes anyway.
    loaded_iter = 0
    total = 0
    last_info: dict = {}
    schema = None
    shapes = None
    for cid, mdir in chunk_model_dirs.items():
        arrays, mask, info, it = _load(cid, mdir)
        loaded_iter = max(loaded_iter, it)
        last_info = info
        total += int(mask.sum())
        chunk_shapes = {k: v.shape[1:] for k, v in arrays.items()}
        if schema is None:
            shapes = chunk_shapes
            idx = np.flatnonzero(mask)[:1]
            props, _ = explicit_ply_props(
                cfg, {k: v[idx] for k, v in arrays.items()})
            schema = [(k, np.float32) for k in props]
        elif shapes != chunk_shapes:
            raise ValueError(f"chunk {cid} has a different explicit-PLY "
                             f"schema than the first chunk — chunks must "
                             f"be trained with the same color_attr/LOD "
                             f"settings to merge")

    if last_info:
        cfg = dataclasses.replace(
            cfg,
            standard_dist=float(last_info.get("standard_dist",
                                              cfg.standard_dist)),
            aerial_levels=int(last_info.get("aerial_levels",
                                            cfg.aerial_levels)),
            street_levels=int(last_info.get("street_levels",
                                            cfg.street_levels)))

    obj_info = []
    if cfg.is_lod:
        obj_info = [f"standard_dist {cfg.standard_dist:.6f}",
                    f"aerial_levels {cfg.aerial_levels:.6f}",
                    f"street_levels {cfg.street_levels:.6f}"]

    out_dir = os.path.join(merged_dir, "point_cloud",
                           f"iteration_{loaded_iter}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "point_cloud_explicit.ply")

    # pass 2: crop-and-append each chunk into the output
    with PlyStreamWriter(path, schema, total, obj_info) as w:
        for cid, mdir in chunk_model_dirs.items():
            arrays, mask, _, _ = _load(cid, mdir)
            props, _ = explicit_ply_props(
                cfg, {k: v[mask] for k, v in arrays.items()})
            w.append(props)
    return path
