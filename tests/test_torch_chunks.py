"""Port parity, chunk scale-out: `io/plyio.PlyStreamWriter`,
`parallel/chunks.{consolidate_chunks,train_chunks}`, `cli/merge.py` and
the fine stage from a coarse model directory, against the JAX package;
then the whole large-scene pipeline through the port alone.

The merge is host numpy in both packages: the merged PLY is held byte for
byte, on chunk directories baked without training (as
`tests/test_partition_merge.py` builds them) by either package. The merged
evaluation (`cli.merge --eval_config`) renders through each package's
explicit path, the JAX one through its Pallas compositor in interpret
mode, the port's through the plain K1: per-view PSNR and SSIM atol 1e-4
with the JAX SSIM blur as a float32 product (`f32_blur`), as
`tests/test_torch_data.py` holds the evaluation. The fine stage's tables
are held bit for bit. The whole pipeline (partition, `train_chunks` coarse
then fine, merge, evaluation) runs on the CPU with K1 and K2 never
launched; the README's merge lines parse."""
import json
import os
import re
import shlex
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import horizongs_tpu.native
import horizongs_tpu_torch.native
from horizongs_tpu.cli.merge import main as j_merge_main
from horizongs_tpu.config import make_model_params as j_model_params
from horizongs_tpu.data.scene import Scene as JScene
from horizongs_tpu.data.synthetic import (
    write_synthetic_blender_dataset as j_write_synthetic)
from horizongs_tpu.io import checkpoints as jck
from horizongs_tpu.io import plyio as jply
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.models import init_anchor_state_from_points as j_init
from horizongs_tpu.models.explicit import bake_explicit as j_bake
from horizongs_tpu.models.factory import new_mlps as j_new_mlps
from horizongs_tpu.parallel import chunks as jchunks
from horizongs_tpu_torch.cli import train as tcli_train
from horizongs_tpu_torch.cli.merge import main as t_merge_main
from horizongs_tpu_torch.cli.partition import main as t_partition_main
from horizongs_tpu_torch.config import make_model_params
from horizongs_tpu_torch.data import scene as tscene_mod
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.data.synthetic import write_synthetic_blender_dataset
from horizongs_tpu_torch.io import checkpoints as tck
from horizongs_tpu_torch.io import plyio as tply
from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.explicit import bake_explicit
from horizongs_tpu_torch.models.factory import new_mlps
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.parallel import chunks as tchunks
from test_torch_data import _assert_states_equal
from test_torch_losses import f32_blur  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 48
SH_LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=0,
              color_attr="SH1", voxel_size=0.1, fork=2, aerial_levels=2,
              street_levels=3, standard_dist=8.0, render_mode="RGB+ED")
MODEL = {"name": "GaussianLoDModel",
         "kwargs": {k: v for k, v in SH_LOD.items() if k != "name"}}
# chunk i owns x in [-4, 0) or [0, 4]; its points spill 0.15 past the cut
TRUE_BOUNDS = {"0_0": [[-4.0, 0.0], [-4.0, 4.0]],
               "1_0": [[0.0, 4.0], [-4.0, 4.0]]}


@pytest.fixture(autouse=True)
def pil_only(monkeypatch):
    """Both packages' image loaders through PIL
    (`tests/test_torch_data.py`)."""
    monkeypatch.setattr(horizongs_tpu.native, "available", lambda: False)
    monkeypatch.setattr(horizongs_tpu_torch.native, "available",
                        lambda: False)


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("blender"))
    j_write_synthetic(path, n_train=6, n_test=2, width=W, height=H)
    return path


# ---------------------------------------------------------------------------
# the stream writer

def test_ply_stream_writer_bytes(tmp_path):
    rng = np.random.default_rng(0)
    schema = [("x", np.float32), ("level", np.float32), ("f", np.float32)]
    info = ["standard_dist 8.000000", "aerial_levels 2.000000"]
    blocks = [{k: rng.normal(size=n).astype(np.float64) for k, _ in schema}
              for n in (5, 0, 11)]
    paths = []
    for name, mod in (("t", tply), ("j", jply)):
        paths.append(str(tmp_path / f"{name}.ply"))
        with mod.PlyStreamWriter(paths[-1], schema, 16, info) as w:
            for b in blocks:
                w.append(b)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    props, got_info = tply.read_ply(paths[0])
    np.testing.assert_array_equal(
        props["f"], np.concatenate([b["f"] for b in blocks]).astype(
            np.float32))
    assert got_info == info
    with pytest.raises(ValueError, match="promised 17 rows, got 16"):
        with tply.PlyStreamWriter(str(tmp_path / "short.ply"), schema, 17,
                                  info) as w:
            for b in blocks:
                w.append(b)


# ---------------------------------------------------------------------------
# consolidate_chunks on baked chunk directories

def _chunk_points(rng, i):
    lo = -0.7 if i == 0 else -0.15
    hi = 0.15 if i == 0 else 0.7
    return rng.uniform([lo, -0.7, -0.7], [hi, 0.7, 0.7],
                       size=(60, 3)).astype(np.float32)


def _bake_chunks(root: str, writer: str, iterations=(30, 40)) -> dict:
    """Two chunk model directories under <root>/chunk_fine/, each its
    initial state with seeded features baked and saved by `writer`'s
    package (no training), with the config.yaml the merge CLI reads."""
    rng = np.random.default_rng(0)
    dirs = {}
    for i, cid in enumerate(TRUE_BOUNDS):
        pts = _chunk_points(rng, i)
        if writer == "jax":
            cfg = JConfig(**SH_LOD)
            state = j_init(cfg, pts, capacity=512)
            state = state._replace(feat=0.3 * jax.random.normal(
                jax.random.PRNGKey(i), state.feat.shape))
            arrays = j_bake(cfg, j_new_mlps(cfg, seed=i), state)
            save = jck.save_explicit_ply
        else:
            cfg = ModelConfig(**SH_LOD)
            state = init_anchor_state_from_points(cfg, pts, device="cpu")
            gen = torch.Generator().manual_seed(i)
            state = state._replace(
                feat=0.3 * torch.randn(state.feat.shape, generator=gen))
            arrays = bake_explicit(cfg, new_mlps(cfg, seed=i, device="cpu"),
                                   state)
            save = tck.save_explicit_ply
        mdir = os.path.join(root, "chunk_fine", cid)
        save(os.path.join(mdir, "point_cloud",
                          f"iteration_{iterations[i]}",
                          "point_cloud_explicit.ply"), cfg, arrays)
        with open(os.path.join(mdir, "config.yaml"), "w") as f:
            yaml.safe_dump({"model_params": {"model_config": MODEL}}, f)
        dirs[cid] = mdir
    return dirs


def _meta():
    return {"chunks": {cid: {"true_bounds": tb,
                             "bounds": [[tb[0][0] - 0.4, tb[0][1] + 0.4],
                                        tb[1]]}
                       for cid, tb in TRUE_BOUNDS.items()}}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_consolidate_matches_jax(tmp_path, writer):
    dirs = _bake_chunks(str(tmp_path / "chunks"), writer)
    pt = tchunks.consolidate_chunks(dirs, _meta(), str(tmp_path / "t"),
                                    ModelConfig(**SH_LOD))
    pj = jchunks.consolidate_chunks(dirs, _meta(), str(tmp_path / "j"),
                                    JConfig(**SH_LOD))
    assert os.path.relpath(pt, tmp_path / "t") == \
        os.path.relpath(pj, tmp_path / "j") == os.path.join(
            "point_cloud", "iteration_40", "point_cloud_explicit.ply")
    assert _read(pt) == _read(pj)
    # the rows inside each chunk's true bounds, in chunk order
    merged, info = tck.load_explicit_ply(pt)
    want = []
    for cid, mdir in dirs.items():
        it = tck.search_max_iteration(os.path.join(mdir, "point_cloud"))
        arr, chunk_info = tck.load_explicit_ply(os.path.join(
            mdir, "point_cloud", f"iteration_{it}",
            "point_cloud_explicit.ply"))
        (x0, x1), (y0, y1) = TRUE_BOUNDS[cid]
        xyz = arr["xyz"]
        keep = ((xyz[:, 0] >= x0) & (xyz[:, 0] <= x1)
                & (xyz[:, 1] >= y0) & (xyz[:, 1] <= y1))
        assert 0 < keep.sum() < len(keep)
        want.append({k: v[keep] for k, v in arr.items()})
    for k in merged:
        np.testing.assert_array_equal(
            merged[k], np.concatenate([w[k] for w in want]), err_msg=k)
    assert info == chunk_info


def _flat_chunk(rng, i, n_in=50, n_out=20, k_sh=4):
    x = np.concatenate([rng.uniform(i, i + 1, size=(n_in,)),
                        rng.uniform(i + 1, i + 1.3, size=(n_out,))])
    n = x.shape[0]
    return {
        "xyz": np.stack([x, rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)],
                        axis=1).astype(np.float32),
        "features": rng.normal(size=(n, k_sh, 3)).astype(np.float32),
        "opacity": rng.uniform(0, 1, n).astype(np.float32),
        "scaling": rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32),
        "rotation": np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
        "level": np.zeros(n, np.int32),
        "extra_level": np.zeros(n, np.float32)}


def _flat_chunks(root, sh_degrees):
    cfg = ModelConfig(name="GaussianModel", feat_dim=8, n_offsets=4,
                      view_dim=0, color_attr="SH1", voxel_size=0.2)
    rng = np.random.default_rng(1)
    dirs, meta = {}, {"chunks": {}}
    for i, k_sh in enumerate(sh_degrees):
        cid = f"{i}_0"
        dirs[cid] = os.path.join(root, cid)
        tck.save_explicit_ply(os.path.join(
            dirs[cid], "point_cloud", "iteration_10",
            "point_cloud_explicit.ply"), cfg, _flat_chunk(rng, i, k_sh=k_sh))
        meta["chunks"][cid] = {
            "true_bounds": [[float(i), float(i + 1)], [-1.0, 1.0]],
            "bounds": [[i - 0.3, i + 1.3], [-1.0, 1.0]]}
    return cfg, dirs, meta


def test_consolidate_streaming_many(tmp_path):
    """12 chunks through both streaming mergers: the same bytes, and every
    in-bounds row exactly once (the spill rows belong to the next chunk)."""
    cfg, dirs, meta = _flat_chunks(str(tmp_path / "chunks"), [4] * 12)
    jcfg = JConfig(name="GaussianModel", feat_dim=8, n_offsets=4,
                   view_dim=0, color_attr="SH1", voxel_size=0.2)
    pt = tchunks.consolidate_chunks(dirs, meta, str(tmp_path / "t"), cfg)
    pj = jchunks.consolidate_chunks(dirs, meta, str(tmp_path / "j"), jcfg)
    assert _read(pt) == _read(pj)
    merged, info = tck.load_explicit_ply(pt)
    assert merged["xyz"].shape[0] == 12 * 50 and info == {}
    xs = merged["xyz"][:, 0]
    assert xs.min() >= 0.0 and xs.max() <= 12.0


def test_consolidate_schema_mismatch(tmp_path):
    cfg, dirs, meta = _flat_chunks(str(tmp_path / "chunks"), [4, 4, 9])
    with pytest.raises(ValueError, match="chunk 2_0 has a different"):
        tchunks.consolidate_chunks(dirs, meta, str(tmp_path / "t"), cfg)
    with pytest.raises(FileNotFoundError, match="no saved iterations"):
        tchunks.consolidate_chunks({"9_0": str(tmp_path)}, meta,
                                   str(tmp_path / "t"), cfg)


def _eval_config(path, source):
    with open(path, "w") as f:
        yaml.safe_dump({"model_params": {
            "model_config": MODEL, "data_format": "blender",
            "source_path": source, "eval": True, "resolution": 1}}, f)
    return str(path)


def test_merge_cli_matches_jax(blender, tmp_path, f32_blur):
    """`cli.merge --eval_config` of each package on copies of one set of
    chunk directories (the JAX package's bakes): the merged PLYs byte for
    byte, the test views' PSNR and SSIM within 1e-4."""
    source = str(tmp_path / "data")
    shutil.copytree(blender, source)
    os.makedirs(os.path.join(source, "chunks"))
    with open(os.path.join(source, "chunks", "partitions.json"), "w") as f:
        json.dump(_meta(), f)
    _bake_chunks(str(tmp_path / "j"), "jax")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    cfg = _eval_config(tmp_path / "eval.yaml", source)
    argv = ["--source_path", source, "--eval_config", cfg]
    assert j_merge_main(["-m", str(tmp_path / "j"), *argv, "--rasterizer",
                         "pallas_interpret"]) == 0
    assert t_merge_main(["-m", str(tmp_path / "t"), *argv,
                         "--device", "cpu"]) == 0
    rel = os.path.join("merged_model", "point_cloud", "iteration_40",
                       "point_cloud_explicit.ply")
    assert _read(tmp_path / "t" / rel) == _read(tmp_path / "j" / rel)
    views = {}
    for name in ("t", "j"):
        with open(tmp_path / name / "merged_model"
                  / "per_view_test.json") as f:
            views[name] = json.load(f)["ours_40"]
    for m in ("PSNR", "SSIM"):
        assert views["t"][m].keys() == views["j"][m].keys()
        assert len(views["t"][m]) == 2
        for k, v in views["j"][m].items():
            assert abs(views["t"][m][k] - v) <= 1e-4, (m, k)
    with open(tmp_path / "t" / "merged_model" / "test" / "ours_40"
              / "per_view_count.json") as f:
        assert min(json.load(f).values()) > 0


# ---------------------------------------------------------------------------
# the fine stage from a coarse model directory

def test_fine_stage_from_model_dir(blender, tmp_path):
    """A coarse model directory the JAX package saved (iteration 30, seeded
    features): the port's fine stage given the directory loads its last
    iteration, equal to the port's and the JAX package's given the
    iteration directory; the JAX package fails on the directory."""
    lp_kw = dict(data_format="blender", source_path=blender, resolution=1)
    cfg = dict(SH_LOD, voxel_size=0.3)
    coarse = str(tmp_path / "coarse")
    j = JScene(j_model_params(model_path=coarse, **lp_kw), JConfig(**cfg))
    rng = np.random.default_rng(2)
    st = j.train_state
    live = (np.arange(st.params.feat.shape[0]) < int(st.n))[:, None]
    st = st._replace(params=st.params._replace(feat=jnp.asarray(
        rng.normal(size=st.params.feat.shape).astype(np.float32) * live)))
    j.save(20, j.train_state)
    j.save(30, st)
    it_dir = os.path.join(coarse, "point_cloud", "iteration_30")
    assert tscene_mod.pretrained_iteration_dir(coarse) == it_dir
    assert tscene_mod.pretrained_iteration_dir(it_dir) == it_dir

    def fine(ckpt, name):
        return Scene(make_model_params(
            model_path=str(tmp_path / name), pretrained_checkpoint=ckpt,
            **lp_kw), ModelConfig(**cfg), device="cpu")
    from_dir, from_it = fine(coarse, "dir"), fine(it_dir, "it")
    jf = JScene(j_model_params(model_path=str(tmp_path / "jf"),
                               pretrained_checkpoint=it_dir, **lp_kw),
                JConfig(**cfg))
    for t in (from_dir, from_it):
        assert (t.stage, t.frozen_mlps) == ("fine", True)
        _assert_states_equal(t.train_state, jf.train_state)
        _assert_states_equal(t.train_state, st)
        assert t.base.keys() == jf.base.keys()
        for k in jf.base:
            np.testing.assert_array_equal(t.base[k], jf.base[k], err_msg=k)
        for a, b in zip(t.train_state.params.mlps.parameters(),
                        from_it.train_state.params.mlps.parameters()):
            assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="point_cloud.ply"):
        JScene(j_model_params(model_path=str(tmp_path / "jd"),
                              pretrained_checkpoint=coarse, **lp_kw),
               JConfig(**cfg))


# ---------------------------------------------------------------------------
# train_chunks

def test_train_chunks_host_selection(monkeypatch):
    calls = []

    def main(argv):
        calls.append(argv)
        return 0 if "c3" not in argv else 1
    monkeypatch.setattr(tcli_train, "main", main)
    cfgs, mps = [f"c{i}" for i in range(5)], [f"m{i}" for i in range(5)]
    tchunks.train_chunks(cfgs, mps, ["--device", "cpu"], host_id=0,
                         n_hosts=2)
    assert calls == [["--config", f"c{i}", "--model_path", f"m{i}",
                      "--device", "cpu"] for i in (0, 2, 4)]
    calls.clear()
    with pytest.raises(RuntimeError, match="chunk job c3 returned 1"):
        tchunks.train_chunks(cfgs, mps, host_id=1, n_hosts=2)
    assert [c[1] for c in calls] == ["c1", "c3"]


def _train_config(path, source, iterations):
    with open(path, "w") as f:
        yaml.safe_dump({
            "model_params": {"model_config": MODEL, "data_format": "blender",
                             "source_path": source, "eval": True,
                             "resolution": 1},
            "optim_params": {"iterations": iterations, "start_stat": 5,
                             "update_from": 20, "update_interval": 15,
                             "update_until": 50}}, f)
    return str(path)


def test_train_chunks_subprocesses(blender, tmp_path):
    """parallel=2: three jobs in subprocesses of the port's train CLI on
    the CPU; the one whose config does not exist fails, and the call
    raises after every job has ended."""
    cfgs = [_train_config(tmp_path / f"c{i}.yaml", blender, 2 + i)
            for i in range(2)] + [str(tmp_path / "missing.yaml")]
    mps = [str(tmp_path / f"m{i}") for i in range(3)]
    with pytest.raises(RuntimeError, match="missing.yaml"):
        tchunks.train_chunks(cfgs, mps, ["--device", "cpu", "--disable_tb",
                                         "--skip_eval"], parallel=2)
    for i in range(2):
        assert os.path.exists(os.path.join(
            mps[i], "point_cloud", f"iteration_{2 + i}", "point_cloud.ply"))


# ---------------------------------------------------------------------------
# the whole pipeline, port only

def test_pipeline_partition_train_merge(tmp_path, monkeypatch):
    """On the 64x64 synthetic dataset (24 train, 4 test views):
    `cli.partition` of configs/synthetic/chunks512.yaml cut to 4 coarse and
    2 fine iterations, `train_chunks` coarse then fine per chunk through
    the generated configs unedited, `cli.merge` with the evaluation. The
    fine stages load their coarse models, the merged rows are the chunks'
    rows inside their true bounds, the merged PSNR is finite, and on the
    CPU the plain K1 and K2 run and the kernels are never launched."""
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    write_synthetic_blender_dataset(data, n_train=24, n_test=4, width=64,
                                    height=64, n_gauss=40, device="cpu")
    with open(os.path.join(ROOT, "configs", "synthetic",
                           "chunks512.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data_params"]["source_path"] = data
    cfg["chunk_coarse"]["optim_params"]["iterations"] = 4
    cfg["chunk_fine"]["optim_params"]["iterations"] = 2
    os.makedirs("cfg")
    with open("cfg/chunks.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    plain = {"fwd": 0, "bwd": 0}
    for name in ("fwd", "bwd"):
        orig = getattr(raster3d, f"rasterize_{name}_plain")

        def counted(*args, _orig=orig, _name=name, **kw):
            plain[_name] += 1
            return _orig(*args, **kw)
        monkeypatch.setattr(raster3d, f"rasterize_{name}_plain", counted)
    scenes = []

    class Recorded(tscene_mod.Scene):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scenes.append(self)
    monkeypatch.setattr(tscene_mod, "Scene", Recorded)
    launched = (raster3d.KERNEL.launches, raster3d.KERNEL_BWD.launches)

    assert t_partition_main(["--config", "cfg/chunks.yaml"]) == 0
    with open(os.path.join(data, "chunks", "partitions.json")) as f:
        meta = json.load(f)
    assert sorted(meta["chunks"]) == ["0_0", "1_0"]
    root = os.path.join("outputs", "synthetic", "chunks512")
    cfgs, mps = [], []
    for cid in meta["chunks"]:
        for stage in ("chunk_coarse", "chunk_fine"):
            cfgs.append(os.path.join("cfg", stage, f"{cid}.yaml"))
            mps.append(os.path.join(root, stage, cid))
    tchunks.train_chunks(cfgs, mps, ["--device", "cpu", "--disable_tb"])
    assert [s.stage for s in scenes] == ["coarse", "fine"] * 2
    for s in scenes[1::2]:
        assert s.train_state.n == s.base["anchor"].shape[0] > 0

    ev = {k: v for k, v in cfg["data_params"].items()
          if k not in ("n_width", "n_height", "overlap_area",
                       "visible_rate", "xyz_plane")}
    with open("cfg/eval.yaml", "w") as f:
        yaml.safe_dump({"model_params": ev}, f)
    assert t_merge_main(["-m", root, "--source_path", data, "--eval_config",
                         "cfg/eval.yaml", "--device", "cpu"]) == 0
    merged, _ = tck.load_explicit_ply(os.path.join(
        root, "merged_model", "point_cloud", "iteration_2",
        "point_cloud_explicit.ply"))
    kept = 0
    for cid, c in meta["chunks"].items():
        arr, _ = tck.load_explicit_ply(os.path.join(
            root, "chunk_fine", cid, "point_cloud", "iteration_2",
            "point_cloud_explicit.ply"))
        (x0, x1), (y0, y1) = c["true_bounds"]
        xyz = arr["xyz"]
        kept += int(((xyz[:, 0] >= x0) & (xyz[:, 0] <= x1)
                     & (xyz[:, 1] >= y0) & (xyz[:, 1] <= y1)).sum())
    assert merged["xyz"].shape[0] == kept > 0
    with open(os.path.join(root, "merged_model", "results_test.json")) as f:
        res = json.load(f)["ours_2"]["all"]
    assert res["n_views"] == 4 and np.isfinite(res["PSNR"])
    assert plain["fwd"] > 0 and plain["bwd"] > 0
    assert (raster3d.KERNEL.launches, raster3d.KERNEL_BWD.launches) == \
        launched


# ---------------------------------------------------------------------------
# the README's merge lines

def _readme_merge_lines():
    with open(os.path.join(ROOT, "README.md")) as f:
        text = f.read().replace("\\\n", " ")
    return re.findall(r"python -m (horizongs_tpu(?:_torch)?)\.cli\.merge"
                      r"([^\n`]*)", text)


@pytest.mark.parametrize("pkg", ["horizongs_tpu", "horizongs_tpu_torch"])
def test_readme_merge_lines_parse(pkg, tmp_path):
    """Each `cli.merge` command the README gives takes only flags the CLI
    has: run with its paths swapped for empty ones, it gets past argparse
    (which exits 2 on an unknown flag) to the missing partitions.json."""
    lines = [args for p, args in _readme_merge_lines() if p == pkg]
    assert lines
    main = j_merge_main if pkg == "horizongs_tpu" else t_merge_main
    for args in lines:
        argv = [a if a.startswith("-") else str(tmp_path / "none")
                for a in shlex.split(args)]
        with pytest.raises(FileNotFoundError, match="partitions.json"):
            main(argv)
