"""K1's and K2's skip tests on the CPU: the plain copies of the pair
rejection (`skip_threshold`, `segment_reject`) and of the per-warp support
box (`support_box`, `warp_cull`) never skip a pair to which the plain
version gives alpha > 0 (nor one whose raw alpha is NaN, which the kernels'
fminf caps to 0.999), over some 6M pairs of seeded random and edge-case
gaussians; the warp map is a bijection onto the tile; the constants of
csrc/raster3d_common.cuh equal the plain copies'; and on a small flagship
scene the tests skip most of the walked pairs with alpha = 0."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops import reference
from test_torch_cuda import (
    C255,
    ULP,
    _degenerate_gaussians3d,
    _on_box_gaussians3d,
    _opacity_gaussians3d,
    _random_gaussians3d,
)

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _nonfinite_gaussians3d(seed=36, n=300):
    """Random gaussians with one field of each row set to NaN, +inf or
    -inf (the mean, the conic or the opacity), and rows whose products
    overflow to inf - inf."""
    f = _random_gaussians3d(seed, n)
    rng = np.random.default_rng(seed)
    bad = torch.tensor([math.nan, math.inf, -math.inf])
    for j in range(n - 20):
        f[j, int(rng.integers(0, 6))] = bad[j % 3]
    f[n - 20:, 2] = 3e38                      # 0.5 a dx^2 overflows
    f[n - 20:, 3] = -3e38
    return f


SKIP_CASES = {"random": _random_gaussians3d, "opacity": _opacity_gaussians3d,
              "degenerate": _degenerate_gaussians3d,
              "on_box": _on_box_gaussians3d,
              "nonfinite": _nonfinite_gaussians3d}


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skips_never_drop_a_contributing_pair(case):
    """Every pair of every gaussian with every pixel of a 64x64 grid (8e5
    and more pairs per case): the rejection `segment_reject` and the warp
    cull `warp_cull` skip no pair to which `_segment_geometry` gives
    alpha > 0 or a NaN raw alpha, and each case reaches the edge it is
    built for."""
    f = SKIP_CASES[case]()
    ntx, nty = 2, 2
    lx, ly = raster3d.local_pixel_coords("cpu")
    warp = raster3d.warp_of_pixel("cpu")
    box = raster3d.support_box(f)
    whole = torch.isinf(box).all(1) & (box[:, 0] < 0)
    a, b, c = f[:, 2].double(), f[:, 3].double(), f[:, 4].double()
    indefinite = a * c - b * b <= 0
    half = 0.5 * (a + c)
    r = torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    kappa = (half + r) ** 2 / (a * c - b * b)
    n = dict(pairs=0, hit=0, rejected=0, culled=0, hit_at_cutoff=0,
             hit_unbounded=0, hit_ill_conditioned=0, hit_indefinite=0,
             hit_saturated=0, raw_nan=0, on_box_edge=0, skipped_nonpositive=0)
    for t in range(ntx * nty):
        _, _, raw, alpha = raster3d._segment_geometry(f, t, ntx, lx, ly)
        rej = raster3d.segment_reject(f, t, ntx, lx, ly)
        cull = raster3d.warp_cull(f, t, ntx)[warp]
        hit = (alpha > 0) | torch.isnan(raw)
        assert not (hit & rej).any(), "a rejected pair has alpha > 0"
        assert not (hit & cull).any(), "a culled pair has alpha > 0"
        X = (lx + float((t % ntx) * raster3d.TILE_W))[:, None]
        Y = (ly + float((t // ntx) * raster3d.TILE_H))[:, None]
        edge = ((X == box[None, :, 0]) | (X == box[None, :, 1])
                | (Y == box[None, :, 2]) | (Y == box[None, :, 3]))
        n["pairs"] += hit.numel()
        n["hit"] += int(hit.sum())
        n["rejected"] += int(rej.sum())
        n["culled"] += int(cull.sum())
        n["hit_at_cutoff"] += int((hit & (raw < C255 * (1 + 8 * ULP)))
                                  .sum())
        n["hit_unbounded"] += int((hit & whole[None, :]).sum())
        n["hit_ill_conditioned"] += int((hit & (kappa > 1e4)[None, :]
                                         & ~indefinite[None, :]).sum())
        n["hit_indefinite"] += int((hit & indefinite[None, :]).sum())
        n["hit_saturated"] += int((hit & (raw >= 0.999)).sum())
        n["raw_nan"] += int(torch.isnan(raw).sum())
        n["on_box_edge"] += int(edge.sum())
        n["skipped_nonpositive"] += int(((rej | cull)
                                         & (f[None, :, 5] <= 0)).sum())
    assert n["pairs"] >= 8 * 10 ** 5
    assert n["hit"] > 0 and n["rejected"] > n["pairs"] // 4, n
    want = {"random": ("hit_ill_conditioned", "hit_unbounded", "culled"),
            "opacity": ("hit_at_cutoff", "skipped_nonpositive", "culled"),
            "degenerate": ("hit_indefinite", "hit_saturated",
                           "hit_unbounded", "culled"),
            "on_box": ("on_box_edge", "culled"),
            "nonfinite": ("raw_nan", "hit_unbounded")}[case]
    assert min(n[key] for key in want) > 0, n


def test_skip_threshold_edges():
    """thr: -1 where op <= 0, NaN (nothing skipped) where op is not finite,
    the floor -80 for a tiny op, elsewhere above ln(op / fl(1/255)) by the
    margin less the float32 rounding it covers (about 1.3e-6, derived in
    csrc/raster3d_common.cuh)."""
    op = torch.tensor([0.0, -0.0, -0.5, float(C255) * (1 - float(ULP)),
                       float(C255), 0.5, 1.0, 7.0, 1e-38, 1e-45, math.nan,
                       math.inf, -math.inf])
    thr = raster3d.skip_threshold(op)
    assert thr[:3].tolist() == [-1.0, -1.0, -1.0]
    assert torch.isnan(thr[10:]).all()
    assert thr[8:10].tolist() == [-80.0, -80.0]
    tau = torch.log(op[3:8].double() / float(C255))
    assert (thr[3:8].double() >= tau + 1e-5 * (1 + tau.abs()) - 1.3e-6).all()
    assert float(thr[6]) > math.log(255) + 6e-5


def test_warp_map_is_a_bijection():
    """The header's warp_pixel(warp, lane, k) covers every pixel of the
    tile once, and `warp_of_pixel` names the warp that owns each: 16 warps
    of 8x8 pixels, 2 pixels a lane."""
    wop = raster3d.warp_of_pixel("cpu")
    seen = torch.zeros(raster3d.P, dtype=torch.int64)
    for w in range(raster3d.WARPS):
        for lane in range(32):
            for k in range(raster3d.P // (32 * raster3d.WARPS)):
                bx = raster3d.TILE_W // raster3d.BLOCK_W
                x = (w % bx) * raster3d.BLOCK_W + lane % raster3d.BLOCK_W
                y = ((w // bx) * raster3d.BLOCK_H + lane // raster3d.BLOCK_W
                     + 32 // raster3d.BLOCK_W * k)
                p = y * raster3d.TILE_W + x
                seen[p] += 1
                assert int(wop[p]) == w
    assert (seen == 1).all()
    assert raster3d.WARPS * raster3d.BLOCK_W * raster3d.BLOCK_H == raster3d.P


def _header_constants():
    """{name: (type, literal)} of the literal `constexpr` constants of
    csrc/raster3d_common.cuh."""
    src = (Path(raster3d.__file__).parent.parent / "csrc"
           / "raster3d_common.cuh").read_text()
    return {m[2]: (m[1], m[3]) for m in re.finditer(
        r"constexpr\s+(int|float|double)\s+(k\w+)\s*=\s*"
        r"(-?[0-9.]+(?:e-?[0-9]+)?)f?\s*;", src)}


_SHARED_CONSTANTS = [
    ("kRejectRel", raster3d.REJECT_REL), ("kRejectAbs", raster3d.REJECT_ABS),
    ("kThrFloor", raster3d.THR_FLOOR),
    ("kBoxRhoScale", raster3d.BOX_RHO_SCALE),
    ("kBoxSigmaRel", raster3d.BOX_SIGMA_REL),
    ("kBoxMaxLoss", raster3d.BOX_MAX_LOSS),
    ("kBoxPadPx", raster3d.BOX_PAD_PX), ("kBoxPadRel", raster3d.BOX_PAD_REL),
    ("kBlockW", raster3d.BLOCK_W), ("kBlockH", raster3d.BLOCK_H),
    ("kTileW", raster3d.TILE_W), ("kTileH", raster3d.TILE_H),
    ("kChunk", raster3d.G), ("kFields", raster3d.N_FIELDS),
    ("kAccRows", raster3d.N_ACC), ("kMaxAlpha", reference.MAX_ALPHA),
    ("kLogTEps", raster3d.LOG_T_EPS)]


@pytest.mark.parametrize("c_name,py", _SHARED_CONSTANTS,
                         ids=[c for c, _ in _SHARED_CONSTANTS])
def test_kernel_constants_match_the_plain_copies(c_name, py):
    """The margins, the warp map and the layout that the kernels' header
    sets are the values the plain copies (`skip_threshold`,
    `segment_reject`, `support_box`, `warp_cull`, `warp_of_pixel`) and the
    chip run's counters use: a change to one side alone fails here."""
    kind, literal = _header_constants()[c_name]
    if kind == "int":
        assert int(literal) == py
    elif kind == "float":
        assert np.float32(literal) == np.float32(py)
    else:
        assert float(literal) == py


def test_skips_do_work_on_a_small_flagship_scene():
    """The flagship LOD model at 128x72 (random weights from seeds): of the
    walked pairs with alpha = 0 (those before each pixel's n_contrib), the
    rejection and the warp cull skip most; of the walked pairs with
    alpha > 0, none."""
    from horizongs_tpu_torch.data.synthetic import (
        orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.models.anchors import (
        init_anchor_state_from_points)
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops.raster_cuda import build_raster_inputs
    from horizongs_tpu_torch.render import decode_view
    W, H = 128, 72
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.05, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    pts = random_gaussians(3000, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    state = init_anchor_state_from_points(cfg, pts, device="cpu")
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(state.capacity) < state.n)[:, None]
    state = state._replace(
        feat=torch.randn(state.feat.shape, generator=gen) * live,
        offset=torch.randn(state.offset.shape, generator=gen)
        * live[:, :, None])
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, 0, cfg.n_offsets,
                     cfg.color_dim, generator=gen, device="cpu")
    cam = orbit_cameras(1, radius=3.5, height_z=-1.0, width=W, height=H,
                        device="cpu")[0]
    with torch.no_grad():
        dec = decode_view(cam, cfg, mlps, state)
        ri = build_raster_inputs(dec.means, dec.quats, dec.scales,
                                 dec.opacities, dec.colors, cam.viewmat,
                                 cam.K, W, H, cap=1 << 17)
        args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
                ri.grid.n_tiles_x, ri.grid.n_tiles_y)
        _, _, nc = raster3d.rasterize_fwd_plain(*args)
    lx, ly = raster3d.local_pixel_coords("cpu")
    warp = raster3d.warp_of_pixel("cpu")
    starts = args[2].tolist()
    dead = skipped = hit = 0
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        f = args[0][args[1][s:e].long()]
        alpha = raster3d.segment_alpha(f, t, args[3], lx, ly)
        skip = (raster3d.segment_reject(f, t, args[3], lx, ly)
                | raster3d.warp_cull(f, t, args[3])[warp])
        walked = torch.arange(e - s)[None, :] < nc[t][:, None]
        assert not (walked & (alpha > 0) & skip).any()
        dead += int((walked & (alpha == 0)).sum())
        skipped += int((walked & (alpha == 0) & skip).sum())
        hit += int((walked & (alpha > 0)).sum())
    assert hit > 10 ** 4 and dead > 10 ** 4
    assert skipped > 0.5 * dead, (skipped, dead)
