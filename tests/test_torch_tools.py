"""Port parity, the measurement tools T1-T3 on the CPU: the T1 workload
against the JAX tool's own arrays, K1's plain version on it against the
JAX forward kernel (interpret mode), T2's scene against the JAX tool's
instance count, T3's plain versions, and the wrappers' CPU rules (T1 and
T2 "full" take K1's and K2's plain versions; T2's stripped variants and
the timing tools raise). The kernels themselves are held on the card in
`tests/test_torch_cuda.py`."""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.ops import grid_overhead as go
from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.tools import fused_fwd
from horizongs_tpu_torch.tools import profile_bwd_variants as pbv
from horizongs_tpu_torch.tools import profile_grid_overhead as pgo

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NTX, NTY = 4, 3


def _jax_tool_workloads(monkeypatch):
    """The (16, CAP+2G) instance columns and tile starts that the JAX tool
    `tools/experiment_fused_fwd.py` builds for each L at NTX x NTY tiles:
    its `main` run with the kernels and jit swapped for a recorder."""
    spec = importlib.util.spec_from_file_location(
        "experiment_fused_fwd", ROOT / "tools" / "experiment_fused_fwd.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = []

    def record(d, ts, ntx, nty):
        if not seen or seen[-1][0] is not d:
            seen.append((d, ts))
        return jnp.zeros(1), jnp.zeros(1)

    monkeypatch.setattr(tool, "rasterize_fwd", record)
    monkeypatch.setattr(tool, "rasterize_fwd_fused", record)
    monkeypatch.setattr(tool.jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(sys, "argv", ["experiment_fused_fwd", "--iters", "1",
                                      "--n_tiles_x", str(NTX),
                                      "--n_tiles_y", str(NTY)])
    tool.main()
    return [(np.asarray(d), np.asarray(ts)) for d, ts in seen]


def test_t1_workload_matches_the_jax_tool(monkeypatch):
    want = _jax_tool_workloads(monkeypatch)
    got = list(fused_fwd.equal_l_workloads(NTX, NTY))
    assert [L for L, _, _ in got] == list(fused_fwd.SWEEP)
    assert len(want) == len(got)
    for (L, fields, starts), (data, ts) in zip(got, want):
        cap = fields.shape[0]
        assert cap == NTX * NTY * L * raster3d.G
        np.testing.assert_array_equal(fields, data[:10, :cap].T)
        np.testing.assert_array_equal(data[10, :cap], 1.0)   # validity row
        assert not data[11:].any() and not data[:, cap:].any()
        np.testing.assert_array_equal(starts, ts)


@pytest.mark.parametrize("L", [1, 2])
def test_k1_plain_on_the_t1_workload_matches_jax(L):
    """K1's plain version on the equal-L workload against the JAX forward
    kernel in interpret mode: rgb, depth and alpha rows and log T at atol
    1e-4. (i_fin differs by convention: the TPU kernel counts chunk pairs
    from a 128-aligned base.)"""
    from horizongs_tpu.ops.pallas.raster3d import INST_DIM, rasterize_fwd
    _, fields, starts = next(w for w in fused_fwd.equal_l_workloads(
        NTX, NTY, Ls=(1, 2)) if w[0] == L)
    cap = fields.shape[0]
    data = np.zeros((INST_DIM, cap + 2 * raster3d.G), np.float32)
    data[:10, :cap] = fields.T
    data[10, :cap] = 1.0
    acc_j, logT_j = rasterize_fwd(jnp.asarray(data), jnp.asarray(starts),
                                  NTX, NTY, interpret=True)
    args = fused_fwd.workload_args(fields, starts, NTX, NTY, "cpu")
    acc, logT, n_contrib = raster3d.rasterize_fwd_plain(*args)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j)[:, 6:11],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(logT[:, 0].numpy(), np.asarray(logT_j)[:, 0],
                               atol=1e-4, rtol=0)
    assert float(acc[:, 4].max()) > 0.01         # the gaussians are seen
    assert (n_contrib == L * raster3d.G).all()   # opacity 0.005: no stop


def test_t1_cpu_path_and_tool():
    _, fields, starts = next(fused_fwd.equal_l_workloads(NTX, NTY, Ls=(1,)))
    args = fused_fwd.workload_args(fields, starts, NTX, NTY, "cpu")
    ref = raster3d.rasterize_fwd_plain(*args)
    for s in raster3d.SCHEDULES:
        assert fused_fwd.mismatches(
            raster3d.rasterize_fwd_persistent(*args, schedule=s), ref) == 0
    with pytest.raises(ValueError):
        raster3d.rasterize_fwd_persistent(*args, schedule="hardware")
    with pytest.raises(ValueError):
        raster3d.persistent_grid(NTX * NTY, "hardware", "cuda")
    assert fused_fwd.check_schedules(args) == {"static": [0, 0],
                                               "dynamic": [0, 0]}
    assert fused_fwd.main(["--device", "cpu", "--n_tiles_x", "2",
                           "--n_tiles_y", "1"]) == 0


def test_t2_scene_matches_the_jax_tool():
    """T2's scene at 3000 gaussians and 256x160: the JAX tool's projection,
    cull and binning (`tools/profile_bwd_variants.py:207-221`) enumerate
    as many instances, and the cotangents are d_acc = 1, d_logT = 0."""
    from horizongs_tpu.data.synthetic import lookat_camera, random_gaussians
    from horizongs_tpu.ops.binning import build_tile_instances
    from horizongs_tpu.ops.projection import project_3dgs
    from horizongs_tpu.ops.raster import _make_grid
    n, W, H = 3000, 256, 160
    g = {k: jnp.asarray(v) for k, v in random_gaussians(
        n, seed=0, extent=1.5, scale_range=(0.004, 0.02)).items()}
    cam = lookat_camera(width=W, height=H, eye=(0, 0, -4))
    grid = _make_grid(W, H, 32, 32)
    proj = project_3dgs(g["means"], g["quats"], g["scales"], cam.viewmat,
                        cam.K, W, H)
    radii = jnp.where(g["opacities"] >= 1 / 255.0, proj.radii, 0.0)
    inst = build_tile_instances(
        proj.means2d, radii, proj.depths, grid.n_tiles_x, grid.n_tiles_y, 32,
        32, -(-6 * n // 128) * 128, conics=proj.conics,
        opacities=g["opacities"])
    args, ri = pbv.bwd_scene(n, W, H, device="cpu")
    assert int(ri.inst.n_instances) == int(inst.n_instances) > 0
    assert int(ri.inst.n_dropped) == 0
    assert bool((args[3] == 1).all()) and bool((args[4] == 0).all())
    assert (args[7], args[8]) == (grid.n_tiles_x, grid.n_tiles_y)


def test_t2_variants_on_the_cpu():
    args, _ = pbv.bwd_scene(400, 96, 64, device="cpu")
    torch.testing.assert_close(raster3d.rasterize_bwd_variant("full", *args),
                               raster3d.rasterize_bwd_plain(*args),
                               atol=0, rtol=0)
    for v in raster3d.VARIANTS[1:]:
        with pytest.raises(ValueError, match="no CPU version"):
            raster3d.rasterize_bwd_variant(v, *args)
    with pytest.raises(ValueError):
        raster3d.rasterize_bwd_variant("no_scan", *args)
    with pytest.raises(ValueError):
        raster3d.variant_occupancy("no_scan", 0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pbv.main(["--device", "cpu"])


def test_t3_plain_versions():
    n = 5
    r = np.random.default_rng(0)
    inst = torch.from_numpy(r.normal(size=(go.ROWS, 256)).astype(np.float32))
    out = torch.full((n, go.ROWS, go.P), 7.0)
    assert go.write(out) is out and bool((out == 0).all())
    torch.testing.assert_close(go.write_plain(n, "cpu"), out, atol=0, rtol=0)
    go.one_copy(inst, out)
    assert bool((out == inst[0, 0]).all())
    torch.testing.assert_close(go.one_copy_plain(inst, n), out, atol=0,
                               rtol=0)
    go.empty(n, "cpu")                        # nothing to do on the CPU
    with pytest.raises(ValueError):
        go.write(torch.zeros((n, go.ROWS, 512)))
    with pytest.raises(ValueError):
        go.one_copy(inst[:, :64].contiguous(), out)
    assert go.GRIDS == (255, 1020, 2040, 4080)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pgo.main(["--device", "cpu"])
