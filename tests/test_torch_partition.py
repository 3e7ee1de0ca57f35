"""Port parity, partitioning: `data/partition.py`, `cli/partition.py` and
`parallel/chunks.generate_chunk_configs` against the JAX package's, on the
same inputs. Both are host numpy, so every result is held exactly: the
geometry helpers' outputs, the per-chunk masks and camera lists, and the
files (partitions.json, each chunk's points3d.ply and transforms.json, the
chunk and single-scene configs) byte for byte. Scenes: a city-like grid
of downward aerial cameras over a spread-out cloud at 2x2
(`tests/test_partition_merge.py`), and the synthetic Blender orbit capture
(the JAX package's writer, 64x64, 24 train and 4 test views) at 2x1 and at
2x2, where two chunks take in no point: both packages write the same
files, the JAX reader fails on the empty PLY and the port's `Scene` says
what is wrong (`ROADMAP.md` §3)."""
import dataclasses
import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from horizongs_tpu.cli.partition import main as j_partition_main
from horizongs_tpu.config import make_model_params as j_model_params
from horizongs_tpu.data import partition as jp
from horizongs_tpu.data import readers as jrd
from horizongs_tpu.data.synthetic import (
    write_synthetic_blender_dataset as j_write_synthetic)
from horizongs_tpu.io import plyio as jply
from horizongs_tpu.parallel import chunks as jchunks
from horizongs_tpu_torch.cli.partition import main as t_partition_main
from horizongs_tpu_torch.config import make_model_params
from horizongs_tpu_torch.data import partition as tp
from horizongs_tpu_torch.data import readers as trd
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.io import plyio as tply
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.parallel import chunks as tchunks
from test_partition_merge import _city_like_scene

torch.set_num_threads(1)

W = H = 64
MODEL = {"name": "GaussianLoDModel", "kwargs": {
    "fork": 2, "gs_attr": "3D", "color_attr": "SH1", "feat_dim": 8,
    "view_dim": 0, "appearance_dim": 0, "n_offsets": 4, "voxel_size": 0.3,
    "render_mode": "RGB+ED", "standard_dist": 8.0, "aerial_levels": 2,
    "street_levels": 4}}


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """The synthetic orbit capture: 16 aerial and 8 street train views and
    4 test views around a 40-point cloud of extent 0.7."""
    path = str(tmp_path_factory.mktemp("orbit"))
    j_write_synthetic(path, n_train=24, n_test=4, width=W, height=H)
    return path


def _t_pcd(pcd):
    return trd.BasicPointCloud(pcd.points.copy(), pcd.colors.copy(),
                               pcd.normals.copy())


def _t_infos(infos):
    return [trd.CameraInfo(**dataclasses.asdict(c)) for c in infos]


def _city():
    """The city-like grid, as each package's types, with the frames a
    city dataset's transforms.json would hold."""
    pcd, infos = _city_like_scene()
    frames = [{"file_path": f"aerial/{c.image_name}.png",
               "transform_matrix": np.eye(4).tolist(),
               "camera_angle_x": float(c.fovx)} for c in infos]
    return (pcd, infos), (_t_pcd(pcd), _t_infos(infos)), frames


def _train_frames(source):
    with open(os.path.join(source, "transforms_train.json")) as f:
        content = json.load(f)
    frames = sorted(content["frames"], key=lambda x: x["file_path"])
    for fr in frames:
        fr.setdefault("camera_angle_x", content.get("camera_angle_x"))
    return frames


def _assert_trees_equal(a, b, skip=("partitions.png",)):
    """Every file under `a` is under `b` with the same bytes, and back."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if f not in skip)
    fa, fb = files(a), files(b)
    assert fa == fb
    assert fa
    for rel in fa:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


def _assert_parts_equal(pt, pj):
    assert pt.keys() == pj.keys()
    for pid in pj:
        t, j = pt[pid], pj[pid]
        assert t["bounds"] == j["bounds"] and \
            t["true_bounds"] == j["true_bounds"], pid
        np.testing.assert_array_equal(t["pcd_mask"], j["pcd_mask"])
        np.testing.assert_array_equal(t["extra_point_mask"],
                                      j["extra_point_mask"])
        assert [c.image_path for c in t["cameras"]] == \
            [c.image_path for c in j["cameras"]], pid


# ---------------------------------------------------------------------------
# geometry helpers

def test_point_in_image_matches():
    (pcd, infos), (tpcd, tinfos), _ = _city()
    rng = np.random.default_rng(0)
    pts = np.concatenate([pcd.points.astype(np.float64),
                          rng.uniform(-6, 6, (200, 3))])
    for i in (0, 7, 17):
        got = tp.point_in_image(tp.CamGeom(tinfos[i], i), pts)
        want = jp.point_in_image(jp.CamGeom(infos[i], i), pts)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[2].any() and not got[2].all()


def _hull_cases():
    rng = np.random.default_rng(1)
    cases = [rng.uniform(-30, 80, (int(rng.integers(3, 13)), 2))
             for _ in range(12)]
    cases += [
        np.array([(-10, -10), (100, -10), (100, 100), (-10, 100)], float),
        np.array([(1, 1), (2, 1), (1, 2)], float),          # tiny
        np.array([(0, 0), (10, 10), (20, 20), (30, 30)], float),  # a line
        np.array([(5, 5), (5, 5), (5, 5), (5, 5)], float),  # one point
        np.array([(3, 4), (40, 30), (3, 4), (40, 30)], float),  # two
        np.array([(-50, 10), (-40, 20), (-45, 40), (-60, 5)], float),  # out
    ]
    return cases


@pytest.mark.parametrize("pts", _hull_cases(),
                         ids=lambda p: f"{len(p)}pts")
def test_hull_coverage_matches(pts):
    got = tp.hull_coverage(list(pts), W, H)
    assert got == jp.hull_coverage(list(pts), W, H)
    assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_balanced_segments_matches(m):
    rng = np.random.default_rng(m)
    values = rng.normal(size=23)
    for v in (values, np.repeat(values[:4], 3)):       # ties too
        assert tp._balanced_segments(v, -5.0, 5.0, m) == \
            jp._balanced_segments(v, -5.0, 5.0, m)


@pytest.mark.parametrize("aerial_lod, street_lod",
                         [("multi", "multi"), ("single", "multi"),
                          ("single", "single")])
def test_estimate_lod_params_matches(orbit, aerial_lod, street_lod):
    info_j = jrd.read_blender_scene(orbit, eval=True)
    info_t = trd.read_blender_scene(orbit, eval=True)
    got = tp.estimate_lod_params(
        info_t.point_cloud.points,
        [tp.CamGeom(c, i) for i, c in enumerate(info_t.train_cameras)],
        fork=2, aerial_lod=aerial_lod, street_lod=street_lod)
    want = jp.estimate_lod_params(
        info_j.point_cloud.points,
        [jp.CamGeom(c, i) for i, c in enumerate(info_j.train_cameras)],
        fork=2, aerial_lod=aerial_lod, street_lod=street_lod)
    assert got == want
    # aerial cameras only: the street quantiles come from the aerial ones
    (pcd, infos), (tpcd, tinfos), _ = _city()
    assert tp.estimate_lod_params(
        tpcd.points, [tp.CamGeom(c, i) for i, c in enumerate(tinfos)], 2,
        aerial_lod=aerial_lod, street_lod=street_lod) == \
        jp.estimate_lod_params(
            pcd.points, [jp.CamGeom(c, i) for i, c in enumerate(infos)], 2,
            aerial_lod=aerial_lod, street_lod=street_lod)


# ---------------------------------------------------------------------------
# run_partition: masks, camera lists and files

def test_run_partition_city_grid_2x2(tmp_path):
    (pcd, infos), (tpcd, tinfos), frames = _city()
    kw = dict(source_path="/fake", overlap_area=0.2, visible_rate=0.05)
    pj = jp.run_partition(pcd, infos, 2, 2, str(tmp_path / "j"),
                          frames=frames, **kw)
    pt = tp.run_partition(tpcd, tinfos, 2, 2, str(tmp_path / "t"),
                          frames=frames, **kw)
    assert len(pt) == 4
    _assert_parts_equal(pt, pj)
    _assert_trees_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    with open(tmp_path / "t" / "partitions.json") as f:
        meta = json.load(f)["chunks"]
    assert all(c["n_points"] > 0 and c["n_cameras"] > 0
               for c in meta.values())


def test_run_partition_orbit_2x1(orbit, tmp_path):
    info_j = jrd.read_blender_scene(orbit, eval=True)
    info_t = trd.read_blender_scene(orbit, eval=True)
    frames = _train_frames(orbit)
    kw = dict(source_path=orbit, plane=(0, 1), frames=frames)
    pj = jp.run_partition(info_j.point_cloud, info_j.train_cameras, 2, 1,
                          str(tmp_path / "j"), **kw)
    pt = tp.run_partition(info_t.point_cloud, info_t.train_cameras, 2, 1,
                          str(tmp_path / "t"), **kw)
    _assert_parts_equal(pt, pj)
    _assert_trees_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    # the test views stay out of every chunk
    for pid in pt:
        with open(tmp_path / "t" / pid / "transforms.json") as f:
            names = [fr["file_path"] for fr in json.load(f)["frames"]]
        assert names and not any("/t_" in n for n in names)


@pytest.fixture(scope="module")
def orbit_2x2(orbit, tmp_path_factory):
    """The orbit capture cut 2x2 with its test views merged into the train
    list (eval false), by each package into its own directory."""
    out = tmp_path_factory.mktemp("orbit_2x2")
    frames = _train_frames(orbit)
    for name, rd, part in (("j", jrd, jp), ("t", trd, tp)):
        info = rd.read_blender_scene(orbit, eval=False)
        part.run_partition(info.point_cloud, info.train_cameras, 2, 2,
                           str(out / name), source_path=orbit,
                           plane=(0, 1), frames=frames)
    return out


def test_empty_chunk(orbit_2x2, tmp_path):
    """The 2x2 cut of the orbit capture: the x < 0 half is cut at
    y = -0.765, below the cloud, so chunk 0_0 holds no point. Both
    packages write the same files; the JAX reader fails on the colour
    range of the empty PLY, the port's reads (0, 3) arrays and its Scene
    raises a ValueError that names the file."""
    _assert_trees_equal(str(orbit_2x2 / "t"), str(orbit_2x2 / "j"))
    with open(orbit_2x2 / "t" / "partitions.json") as f:
        meta = json.load(f)["chunks"]
    assert meta["0_0"]["n_points"] == 0
    assert meta["0_0"]["true_bounds"][1][1] == pytest.approx(-0.765, 1e-3)
    ply = str(orbit_2x2 / "t" / "0_0" / "points3d.ply")
    with pytest.raises(ValueError, match="zero-size"):
        jply.read_points_ply(ply)
    pts, cols, norms = tply.read_points_ply(ply)
    assert pts.shape == cols.shape == norms.shape == (0, 3)
    lp = make_model_params(data_format="city", eval=False, resolution=1,
                           source_path=str(orbit_2x2 / "t" / "0_0"),
                           model_path=str(tmp_path / "m"))
    with pytest.raises(ValueError, match="points3d.ply holds no points"):
        Scene(lp, ModelConfig.from_dict(MODEL), device="cpu")


def test_n_cameras_counts_unwritten_frames(orbit_2x2):
    """partitions.json's n_cameras counts every camera of a chunk, also a
    test view merged into the train list whose frame is not in
    transforms_train.json and so is not written (kept as the JAX package
    computes it, `ROADMAP.md` §3)."""
    over = []
    for name in ("t", "j"):
        with open(orbit_2x2 / name / "partitions.json") as f:
            meta = json.load(f)["chunks"]
        for pid, c in meta.items():
            with open(orbit_2x2 / name / pid / "transforms.json") as f:
                written = len(json.load(f)["frames"])
            assert c["n_cameras"] >= written
            over.append(c["n_cameras"] - written)
    assert max(over) > 0
    assert over[:4] == over[4:]


# ---------------------------------------------------------------------------
# configs

@pytest.mark.parametrize("global_yaml", [None, {"optim_params": {
    "iterations": 10}, "pipeline_params": {"vis_step": 0}}],
    ids=["chunks", "with_global"])
def test_generate_chunk_configs_bytes(tmp_path, global_yaml):
    base_t = dict(make_model_params().__dict__, model_config=MODEL)
    base_j = dict(j_model_params().__dict__, model_config=MODEL)
    assert base_t == base_j
    over = ({"optim_params": {"iterations": 30}},
            {"optim_params": {"iterations": 20},
             "pipeline_params": {"add_prefilter": False}})
    args = ("/data/chunks", 2, 3, "ds", "scene")
    pt = tchunks.generate_chunk_configs(str(tmp_path / "t"), base_t, *over,
                                        *args, global_yaml=global_yaml)
    pj = jchunks.generate_chunk_configs(str(tmp_path / "j"), base_j, *over,
                                        *args, global_yaml=global_yaml)
    assert [os.path.relpath(p, tmp_path / "t") for p in pt] == \
        [os.path.relpath(p, tmp_path / "j") for p in pj]
    assert len(pt) == 12
    _assert_trees_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    assert os.path.exists(tmp_path / "t" / "global.yaml") == \
        (global_yaml is not None)


def _partition_config(path, source, **data_params):
    cfg = {"data_params": {
        "source_path": source, "data_format": "blender",
        "dataset_name": "synthetic", "scene_name": "orbit", "eval": True,
        "resolution": 1, "n_width": 2, "n_height": 1, "overlap_area": 0.1,
        "visible_rate": 0.25, "xyz_plane": [1, 1, 0], "model_config": MODEL,
        **data_params},
        "chunk_coarse": {"optim_params": {"iterations": 4}},
        "chunk_fine": {"optim_params": {"iterations": 2}},
        "coarse": {"optim_params": {"iterations": 6}},
        "fine": {"optim_params": {"iterations": 3}}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("partition", [True, False],
                         ids=["chunks", "single_scene"])
def test_partition_cli_bytes(orbit, tmp_path, partition):
    """Each CLI on the same dataset and config: the same chunks and
    configs byte for byte (the dataset's chunks/ moved aside between the
    runs)."""
    source = str(tmp_path / "data")
    shutil.copytree(orbit, source)
    shutil.rmtree(os.path.join(source, "chunks"), ignore_errors=True)
    out = {}
    for name, main in (("j", j_partition_main), ("t", t_partition_main)):
        cfg = _partition_config(str(tmp_path / name / "cfg.yaml"), source,
                                partition=partition)
        assert main(["--config", cfg]) == 0
        if partition:
            os.rename(os.path.join(source, "chunks"),
                      str(tmp_path / name / "chunks"))
        out[name] = str(tmp_path / name)
    _assert_trees_equal(out["t"], out["j"])
    written = sorted(os.listdir(out["t"]))
    if partition:
        assert written == ["cfg.yaml", "chunk_coarse", "chunk_fine",
                           "chunks"]
        with open(os.path.join(out["t"], "chunk_fine", "0_0.yaml")) as f:
            fine = yaml.safe_load(f)["model_params"]
        assert fine["pretrained_checkpoint"] == os.path.join(
            "outputs", "synthetic", "orbit", "chunk_coarse", "0_0")
        lod = fine["model_config"]["kwargs"]
        assert lod["aerial_levels"] >= 1 and lod["standard_dist"] > 0
    else:
        assert written == ["cfg.yaml", "coarse.yaml", "fine.yaml"]
