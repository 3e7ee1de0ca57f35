"""Port parity, the native data plane (`horizongs_tpu_torch/native.py`)
against the JAX package's binding of the same C++ source: the decoded and
resized images, the prefetch pool and the COLMAP points parser, bit for
bit; `_load_image` and the `Scene` cameras of both packages at
`resolution: 2`, through the native loaders and through PIL; the Python
walk of `points3D.bin` against the native parse; six processes importing
the binding at once on a fresh build directory; and a compiler that fails.

The JAX binding builds `native/build/` with an unlocked `make` when a
process first asks for it (`horizongs_tpu/native/__init__.py:38-60`), so
its `available()` is asked inside each test body, never while the module
is collected."""
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import horizongs_tpu.native as jnative
from horizongs_tpu.config import make_model_params as j_model_params
from horizongs_tpu.data import camera_build as jcb
from horizongs_tpu.data import colmap as jcol
from horizongs_tpu.data.scene import Scene as JScene
from horizongs_tpu.data.synthetic import (
    write_synthetic_blender_dataset as j_write_synthetic)
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu_torch import native
from horizongs_tpu_torch.config import make_model_params
from horizongs_tpu_torch.data import camera_build as tcb
from horizongs_tpu_torch.data import colmap as tcol
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.models.config import ModelConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FILES = ("rgb_png", "rgba_png", "gray_png", "rgb_jpg", "gray_jpg")
# (name, target size from the source's (123, 97)): as is, halved
# (`resolution: 2`), and a width target (`resolution: 100`)
SIZES = {"full": (123, 97), "half": (62, 48), "width100": (100, 78)}
LOD = dict(name="GaussianLoDModel", feat_dim=8, n_offsets=4, view_dim=3,
           voxel_size=0.3, fork=2, aerial_levels=2, street_levels=4,
           standard_dist=8.0, render_mode="RGB+ED")


def _both_available():
    assert native.available(), native.unavailable_reason()
    assert jnative.available(), "the JAX package's native/ did not build"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    base = (rng.uniform(0, 255, (97, 123, 3)) * 0.2
            + np.linspace(0, 200, 123)[None, :, None] * 0.8).astype(np.uint8)
    alpha = rng.integers(0, 255, (97, 123, 1), dtype=np.uint8)
    Image.fromarray(base).save(d / "rgb.png")
    Image.fromarray(np.concatenate([base, alpha], -1)).save(d / "rgba.png")
    Image.fromarray(base[..., 0]).save(d / "gray.png")
    Image.fromarray(base).save(d / "rgb.jpg", quality=95)
    Image.fromarray(base[..., 1]).save(d / "gray.jpg", quality=90)
    return {"rgb_png": str(d / "rgb.png"), "rgba_png": str(d / "rgba.png"),
            "gray_png": str(d / "gray.png"), "rgb_jpg": str(d / "rgb.jpg"),
            "gray_jpg": str(d / "gray.jpg")}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FILES)
def test_load_image_rgba_equals_jax_binding(images, name, size):
    _both_available()
    path, (tw, th) = images[name], SIZES[size]
    assert native.image_info(path) == jnative.image_info(path)
    got = native.load_image_rgba(path, tw, th)
    want = jnative.load_image_rgba(path, tw, th)
    assert got.shape == (th, tw, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_image_pool_equals_jax_binding(images):
    _both_available()
    jobs = [(images[n], *SIZES[s]) for n in FILES for s in SIZES]
    with native.ImagePool(3) as pool, jnative.ImagePool(3) as jpool:
        got = pool.load_many(jobs)
        want = jpool.load_many(jobs)
    assert len(got) == len(jobs)
    for (path, tw, th), g, w in zip(jobs, got, want):
        np.testing.assert_array_equal(g, w, err_msg=path)
        np.testing.assert_array_equal(g, native.load_image_rgba(path, tw, th))


def _write_points3d(path, n, seed):
    """A points3D.bin of n points with seeded ids, positions, colours,
    errors and tracks of 0-4 observations."""
    rng = np.random.default_rng(seed)
    tracks = rng.integers(0, 5, n)
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        for i in range(n):
            f.write(np.uint64(rng.integers(1, 1 << 40)).tobytes())
            f.write(rng.normal(size=3).astype("<f8").tobytes())
            f.write(rng.integers(0, 256, 3).astype(np.uint8).tobytes())
            f.write(np.float64(rng.uniform()).tobytes())
            f.write(np.uint64(tracks[i]).tobytes())
            f.write(rng.integers(0, 1000, 2 * tracks[i]).astype("<i4")
                    .tobytes())


def test_points3d_parse_equals_jax_and_the_walk(tmp_path, monkeypatch):
    _both_available()
    path = str(tmp_path / "points3D.bin")
    _write_points3d(path, 500, seed=4)
    got = native.read_colmap_points3d(path)
    for a, b, c in zip(got, jnative.read_colmap_points3d(path),
                       tcol.read_points3D_binary_full(path)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    monkeypatch.setattr(native, "available", lambda: False)
    walk = tcol.read_points3D_binary_full(path)
    assert [a.dtype for a in walk] == [np.int64, np.float64, np.uint8,
                                       np.float64]
    for a, w in zip(got, walk):
        np.testing.assert_array_equal(a, w)
    # the reader the scenes call, through either parser
    np.testing.assert_array_equal(tcol.read_points3D_binary(path)[1],
                                  jcol.read_points3D_binary(path)[1])


@pytest.mark.parametrize("loader", ["native", "pil"])
@pytest.mark.parametrize("name", FILES)
def test_load_image_equals_jax_at_resolution_2(images, name, loader,
                                               monkeypatch):
    _both_available()
    if loader == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    res = (62, 48)
    got = tcb._load_image(images[name], res)
    want = jcb._load_image(images[name], res)
    channels = {"rgb": 3, "rgba": 4, "gray": 1}[name.split("_")[0]]
    assert got.shape == (48, 62, channels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("blender"))
    j_write_synthetic(path, n_train=6, n_test=2, width=48, height=48)
    return path


@pytest.mark.parametrize("loader", ["native", "pil"])
def test_scene_cameras_equal_jax_at_resolution_2(blender, tmp_path, loader,
                                                 monkeypatch):
    _both_available()
    if loader == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(data_format="blender", source_path=blender, resolution=2)
    t = Scene(make_model_params(model_path=str(tmp_path / "t"), **kw),
              ModelConfig(**LOD), device="cpu", logger=None)
    j = JScene(j_model_params(model_path=str(tmp_path / "j"), **kw),
               JConfig(**LOD))
    for get in ("get_train_cameras", "get_test_cameras"):
        tc, jc = getattr(t, get)(), getattr(j, get)()
        assert len(tc) == len(jc) > 0
        for a, b in zip(tc, jc):
            assert (a.width, a.height) == (b.width, b.height) == (24, 24)
            for f in ("image", "alpha_mask"):
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                    err_msg=f)


_CHILD = """
import sys
from pathlib import Path
from horizongs_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.available(), native.library_path().name)
"""


def test_concurrent_first_imports_all_load(tmp_path):
    """Six processes importing the binding at once on an empty build
    directory (as six test workers do): each gets the library, one was
    compiled, and no partial file is left."""
    build = tmp_path / "native"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1 and lines.pop().startswith("True libhgs_io-")
    assert sorted(x.name for x in build.iterdir()
                  if x.name != "build.lock") == [
        outs[0][0].split()[1]]


def test_broken_compiler_falls_back_with_a_reason(tmp_path, monkeypatch,
                                                  caplog, images):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal error: jpeglib.h: No such file "
                   "or directory' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        assert not native.available()
    reason = native.unavailable_reason()
    assert "exited 1" in reason and "jpeglib.h" in reason
    assert [r.levelno for r in caplog.records] == [logging.WARNING]
    assert "jpeglib.h" in caplog.records[0].getMessage()
    assert not list((tmp_path / "native").glob("*.so"))
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.image_info(images["rgb_png"])
    # the callers fall back to PIL
    with Image.open(images["rgba_png"]) as im:
        want = np.asarray(im.resize((62, 48))).astype(np.float32) / 255.0
    np.testing.assert_array_equal(
        tcb._load_image(images["rgba_png"], (62, 48)), want)
