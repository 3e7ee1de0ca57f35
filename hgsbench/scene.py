"""The benchmark's seeded city block, made on the device.

A configuration's `scene` group fixes the block's layout (lots, streets,
building heights), the views' size and field of view and their counts;
the cell's traffic file fixes the table (how many aerial anchors, which
street levels). `--seed` draws everything else: the surface points and so
the anchors, their features, offsets and scalings, the decoders' weights
and the targets. The layout, the training views' poses and the decoders'
weights are the same for every seed (the decoders from a generator of
their own, `DECODER_SEED`), so every seed asks for the same amount of
work: decoders drawn from the seed scale every splat of the table
together, and moved a view's tile instances by a third from seed to seed.

Everything is made with one `torch.Generator` on the scene's device in a
few large calls. Nothing here imports the program: `Tables` and `Views`
hold plain tensors, and `hgsbench.program` hands them to the program,
while the reference gets its own copies.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hgsbench.reference.config import ModelConfig


class Views(NamedTuple):
    """Cameras and targets, each stacked over the views."""
    viewmat: torch.Tensor      # (V, 4, 4) world -> camera
    K: torch.Tensor            # (V, 3, 3)
    center: torch.Tensor       # (V, 3)
    image: torch.Tensor        # (V, H, W, 3)
    alpha_mask: torch.Tensor   # (V, H, W, 1)
    invdepth: torch.Tensor     # (V, H, W, 1)
    depth_mask: torch.Tensor   # (V, H, W, 1)
    is_aerial: list            # V bools
    width: int
    height: int


class Tables(NamedTuple):
    """A capacity-padded anchor table (rows >= n are zero, rotation 1 0 0 0)
    and the decoders' weights, (in, out) as the program stores them."""
    anchor: torch.Tensor       # (C, 3)
    offset: torch.Tensor       # (C, k, 3)
    feat: torch.Tensor         # (C, F)
    scaling_log: torch.Tensor  # (C, 6)
    rotation: torch.Tensor     # (C, 4)
    level: torch.Tensor        # (C,) int32
    extra_level: torch.Tensor  # (C,)
    n: int
    mlp: dict                  # name -> (w1, b1, w2, b2); "appearance" ->
                               # (table,) where appearance_dim > 0



def host_copy(t: Tables) -> Tables:
    """A copy of the tables in host memory, which the program never sees
    (on a CPU device too)."""
    def cp(x):
        return x.detach().to("cpu", copy=True)
    return Tables(*(cp(x) for x in t[:7]), t.n,
                  {k: tuple(cp(x) for x in v) for k, v in t.mlp.items()})


DECODER_SEED = 0


def round_capacity(n: int, block: int = 4096) -> int:
    """Copy of horizongs_tpu_torch/models/anchors.py::round_capacity
    (commit 9bef012): the padded capacity of n rows."""
    return max(block, ((n + block - 1) // block) * block)


def level_size(model: dict, level) -> float:
    """Voxel size of an octree level: voxel_size / fork^(level + 1 -
    aerial_levels), as `octree_sample` sizes its grids."""
    return model["voxel_size"] / float(model["fork"]) ** (
        level + 1 - model["aerial_levels"])


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _nominal_rects(layout: dict):
    """Axis-aligned rectangles (origin, u, v) of the nominal block: the
    ground between the buildings, the roofs and the four walls of each
    building. z is up; the block spans [0, L] x [0, L]."""
    lot, street, n = layout["lot"], layout["street"], layout["lots"]
    heights = layout["heights"]
    L = n * lot + (n + 1) * street
    rects = []
    # ground: the street strips (full-length along x) and the pieces of
    # the cross streets between them
    for i in range(n + 1):
        y0 = i * (lot + street)
        rects.append(((0.0, y0, 0.0), (L, 0.0, 0.0), (0.0, street, 0.0)))
    for j in range(n):
        y0 = street + j * (lot + street)
        for i in range(n + 1):
            x0 = i * (lot + street)
            rects.append(((x0, y0, 0.0), (street, 0.0, 0.0), (0.0, lot, 0.0)))
    for j in range(n):
        for i in range(n):
            h = heights[j * n + i]
            x0 = street + i * (lot + street)
            y0 = street + j * (lot + street)
            rects.append(((x0, y0, h), (lot, 0.0, 0.0), (0.0, lot, 0.0)))
            rects.append(((x0, y0, 0.0), (lot, 0.0, 0.0), (0.0, 0.0, h)))
            rects.append(((x0, y0 + lot, 0.0), (lot, 0.0, 0.0), (0.0, 0.0, h)))
            rects.append(((x0, y0, 0.0), (0.0, lot, 0.0), (0.0, 0.0, h)))
            rects.append(((x0 + lot, y0, 0.0), (0.0, lot, 0.0), (0.0, 0.0, h)))
    return rects, L


def _area(r) -> float:
    u, v = r[1], r[2]
    cx = (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
          u[0] * v[1] - u[1] * v[0])
    return math.sqrt(sum(c * c for c in cx))


def block_geometry(cfg: dict):
    """(rects, L, scale): the layout scaled so that the octree sample of
    its surfaces holds about `anchors` x `overprovision` anchors; the
    sample is then cut to `anchors` exactly."""
    model, sc = cfg["model"], cfg["scene"]
    rects, L = _nominal_rects(sc["layout"])
    area = sum(_area(r) for r in rects)
    per_area = sum(1.0 / level_size(model, lv) ** 2
                   for lv in range(model["aerial_levels"]))
    scale = math.sqrt(sc["anchors"] * sc["overprovision"] / (area * per_area))
    rects = [tuple(tuple(c * scale for c in vec) for vec in r) for r in rects]
    return rects, L * scale, scale


def sample_surface(rects, n: int, gen: torch.Generator, device,
                   max_height: float = float("inf")) -> torch.Tensor:
    """n points uniform by area on the rectangles, cut at `max_height`
    (the part of each wall below it)."""
    o = torch.tensor([r[0] for r in rects], device=device)
    u = torch.tensor([r[1] for r in rects], device=device)
    v = torch.tensor([r[2] for r in rects], device=device)
    v = torch.where((v[:, 2:3] > max_height), v * (max_height / v[:, 2:3]),
                    v)
    area = torch.linalg.norm(torch.cross(u, v, dim=1), dim=1)
    idx = torch.multinomial(area / area.sum(), n, replacement=True,
                            generator=gen)
    ab = torch.rand((n, 2), generator=gen, device=device)
    return o[idx] + ab[:, :1] * u[idx] + ab[:, 1:] * v[idx]


def octree_sample(points: torch.Tensor, model: dict):
    """Copy of horizongs_tpu_torch/models/anchors.py::octree_sample (commit
    9bef012) on the device: level l keeps one point per voxel of size
    voxel_size / fork^(l + 1 - aerial_levels), at the voxel's centre
    (padding 0). Returns (positions (N, 3), levels (N,) int32)."""
    pts, lvs = [], []
    for lv in range(model["aerial_levels"]):
        size = level_size(model, lv)
        q = torch.round(points.double() / size).long()
        q = torch.unique(q, dim=0)
        pts.append((q.double() * size).float())
        lvs.append(torch.full((q.shape[0],), lv, dtype=torch.int32,
                              device=points.device))
    return torch.cat(pts), torch.cat(lvs)


# ---------------------------------------------------------------------------
# the table and the decoders
# ---------------------------------------------------------------------------

def _mlp(gen, d_in: int, d_hidden: int, d_out: int, device):
    """torch.nn.Linear's default init (Kaiming-uniform weights, fan-in
    uniform biases), weights stored (in, out)."""
    def u(shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
    return (u((d_in, d_hidden), math.sqrt(3.0 / d_in)),
            u((d_hidden,), 1.0 / math.sqrt(d_in)),
            u((d_hidden, d_out), math.sqrt(3.0 / d_hidden)),
            u((d_out,), 1.0 / math.sqrt(d_hidden)))


def make_tables(cfg: dict, table: dict, gen: torch.Generator,
                device) -> Tables:
    """The anchor table a cell trains or serves: `table["aerial"]` rows of
    the block's octree sample on levels 0..aerial_levels-1, and, where
    `table["street_levels"]` is given, `table["street_per_level"]` rows on
    each of those levels, on the streets' ground and the walls below
    `table["street_height"]` (x the block's scale). Features N(0, 1),
    offsets N(0, 0.5), log scalings log(level size) + N(0, 0.1), from
    `gen`; the decoders from `DECODER_SEED`: opacity and cov take
    F + view_dim, color F + view_dim + appearance_dim and gives
    color_dim x k (3 for RGB, 3(d+1)^2 for SH{d}); where appearance_dim >
    0, an appearance table of one N(0, 1) row per training view is drawn
    after them, so that the RGB, appearance-free configurations draw what
    they always drew."""
    model, sc = cfg["model"], cfg["scene"]
    rects, _, scale = block_geometry(cfg)
    area = sum(_area(r) for r in rects)
    n_pts = int(sc["points_per_finest_voxel"] * area
                / level_size(model, model["aerial_levels"] - 1) ** 2)
    pts, lvs = octree_sample(sample_surface(rects, n_pts, gen, device),
                             model)
    n_aerial = int(table["aerial"])
    if pts.shape[0] < n_aerial:
        raise ValueError(f"the octree sample holds {pts.shape[0]} anchors, "
                         f"fewer than the {n_aerial} asked for")
    keep = torch.randperm(pts.shape[0], generator=gen, device=device)
    keep = torch.sort(keep[:n_aerial]).values
    pts, lvs = pts[keep], lvs[keep]
    levels = table.get("street_levels", [])
    if levels:
        per = int(table["street_per_level"])
        street = [r for r in rects if r[0][2] == 0.0]     # ground and walls
        sp = sample_surface(street, per * len(levels), gen, device,
                            max_height=table["street_height"] * scale)
        pts = torch.cat([pts, sp])
        lvs = torch.cat([lvs, torch.tensor(levels, dtype=torch.int32,
                                           device=device)
                         .repeat_interleave(per)])
    n = pts.shape[0]
    C = round_capacity(n)
    k, F = model["n_offsets"], model["feat_dim"]
    size = model["voxel_size"] / float(model["fork"]) ** (
        lvs.float() + 1 - model["aerial_levels"])
    scaling = (torch.log(size)[:, None]
               + 0.1 * torch.randn((n, 6), generator=gen, device=device))

    def pad(a):
        out = torch.zeros((C,) + a.shape[1:], dtype=a.dtype, device=device)
        out[:n] = a
        return out

    rotation = torch.zeros((C, 4), device=device)
    rotation[:, 0] = 1.0
    mcfg = ModelConfig.from_dict(cfg["yaml"]["model_params"]["model_config"])
    view, app = mcfg.view_dim, mcfg.appearance_dim
    dec = torch.Generator(device=device)
    dec.manual_seed(DECODER_SEED)
    mlp = {"opacity": _mlp(dec, F + view, F, k, device),
           "cov": _mlp(dec, F + view, F, 7 * k, device),
           "color": _mlp(dec, F + view + app, F, mcfg.color_dim * k, device)}
    if app > 0:
        rows = sc["aerial_views"] + sc["street_views"]
        mlp["appearance"] = (torch.randn((rows, app), generator=dec,
                                         device=device),)
    return Tables(
        anchor=pad(pts),
        offset=pad(0.5 * torch.randn((n, k, 3), generator=gen,
                                     device=device)),
        feat=pad(torch.randn((n, F), generator=gen, device=device)),
        scaling_log=pad(scaling),
        rotation=rotation,
        level=pad(lvs),
        extra_level=torch.zeros((C,), device=device),
        n=n, mlp=mlp)


# ---------------------------------------------------------------------------
# views and targets
# ---------------------------------------------------------------------------

def lookat(eye, target, fovx: float, width: int, height: int):
    """(viewmat (4, 4), K (3, 3)) of a camera at `eye` looking at `target`
    with z up, OpenCV axes (x right, y down, z forward); the arithmetic of
    horizongs_tpu_torch/data/synthetic.py::lookat_camera and
    core/cameras.py::make_camera (commit 9bef012), in float64 then
    float32."""
    eye = torch.as_tensor(eye, dtype=torch.float64)
    fwd = torch.as_tensor(target, dtype=torch.float64) - eye
    fwd = fwd / torch.linalg.norm(fwd)
    up = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64)
    right = torch.linalg.cross(up, fwd)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=1)      # camera -> world
    viewmat = torch.eye(4, dtype=torch.float64)
    viewmat[:3, :3] = R.T
    viewmat[:3, 3] = -R.T @ eye
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    fx = width / (2.0 * math.tan(fovx / 2.0))
    fy = height / (2.0 * math.tan(fovy / 2.0))
    K = torch.tensor([[fx, 0, width / 2.0], [0, fy, height / 2.0],
                      [0, 0, 1]], dtype=torch.float64)
    return viewmat.float(), K.float()


def aerial_pose(cfg: dict, L: float, ring: int, azimuth: float,
                jitter: torch.Tensor):
    """(eye, target) of an aerial view on ring `ring`, jitter (4,) in
    [-1, 1]: elevation, distance, and the target's x, y."""
    sc = cfg["scene"]
    el = math.radians(sc["aerial_elevation_deg"][ring]
                      + 3.0 * float(jitter[0]))
    d = sc["aerial_distance"][ring] * (1.0 + 0.05 * float(jitter[1]))
    c = (L / 2 + 0.1 * L * float(jitter[2]), L / 2 + 0.1 * L * float(jitter[3]),
         0.0)
    eye = (c[0] + d * math.cos(el) * math.cos(azimuth),
           c[1] + d * math.cos(el) * math.sin(azimuth), d * math.sin(el))
    return eye, c


def street_pose(cfg: dict, scale: float, corridor: int, along: float,
                sign: float, jitter: torch.Tensor):
    """(eye, target) of a street view in corridor `corridor` (the first
    lots+1 run along x, the rest along y) at fraction `along` of its
    length, looking along it (`sign`), jitter (2,) in [-1, 1]: height and
    heading."""
    lay = cfg["scene"]["layout"]
    lot, street, n = (lay["lot"] * scale, lay["street"] * scale, lay["lots"])
    L = n * lot + (n + 1) * street
    mid = (corridor % (n + 1)) * (lot + street) + street / 2
    h = cfg["scene"]["street_eye_height"] * scale * (1 + 0.2 * float(jitter[0]))
    heading = 0.1 * float(jitter[1])
    pos = along * L
    look = 0.25 * L
    if corridor <= n:        # along x
        eye = (pos, mid, h)
        target = (pos + sign * look, mid + heading * look, 0.4 * h)
    else:
        eye = (mid, pos, h)
        target = (mid + heading * look, pos + sign * look, 0.4 * h)
    return eye, target


def _smooth_field(gen, n_views: int, H: int, W: int, channels: int,
                  device, terms: int = 4) -> torch.Tensor:
    """(V, H, W, channels) in about [0, 1]: a sum of `terms` random
    low-frequency plane waves per channel."""
    y = torch.linspace(0, 1, H, device=device)[:, None]
    x = torch.linspace(0, 1, W, device=device)[None, :]
    out = torch.full((n_views, H, W, channels), 0.5, device=device)
    k = torch.rand((n_views, channels, terms, 2), generator=gen,
                   device=device) * 12.0 - 6.0
    ph = torch.rand((n_views, channels, terms), generator=gen,
                    device=device) * 2 * math.pi
    for v in range(n_views):
        for c in range(channels):
            for t in range(terms):
                out[v, :, :, c] += (0.4 / terms) * torch.sin(
                    k[v, c, t, 0] * x + k[v, c, t, 1] * y + ph[v, c, t])
    return out


def make_views(cfg: dict, gen: torch.Generator, device) -> Views:
    """The training views: `aerial_views` evenly spaced in azimuth on
    `len(aerial_distance)` rings above the block and `street_views`
    evenly spaced along its corridors, in alternate directions; the poses
    are the configuration's alone, so every seed trains on the same views.
    The targets are drawn from the seed: smooth RGB, alpha-mask (street
    views: sky in the top quarter) and inverse-depth fields."""
    sc = cfg["scene"]
    _, L, scale = block_geometry(cfg)
    W, H = sc["width"], sc["height"]
    n_a, n_s = sc["aerial_views"], sc["street_views"]
    rings = len(sc["aerial_distance"])
    still = torch.zeros(4)
    mats, Ks, centers, aerial = [], [], [], []
    for i in range(n_a):
        ring, j = i % rings, i // rings
        az = 2 * math.pi * (j + ring / rings) / (n_a // rings)
        eye, tgt = aerial_pose(cfg, L, ring, az, still)
        vm, K = lookat(eye, tgt, math.radians(sc["aerial_fov_deg"]), W, H)
        mats.append(vm), Ks.append(K), centers.append(eye), aerial.append(True)
    corridors = 2 * (sc["layout"]["lots"] + 1)
    passes = -(-n_s // corridors)
    for i in range(n_s):
        k = i // corridors
        eye, tgt = street_pose(cfg, scale, i % corridors,
                               0.15 + 0.7 * (k + 0.5) / passes,
                               1.0 if (i + k) % 2 == 0 else -1.0, still)
        vm, K = lookat(eye, tgt, math.radians(sc["street_fov_deg"]), W, H)
        mats.append(vm), Ks.append(K), centers.append(eye), aerial.append(False)
    V = n_a + n_s
    image = _smooth_field(gen, V, H, W, 3, device).clamp(0, 1)
    alpha = torch.ones((V, H, W, 1), device=device)
    sky = int(H * 0.25)
    for v in range(n_a, V):
        alpha[v, :sky] = 0.0
    invdepth = 0.05 + 0.5 * _smooth_field(gen, V, H, W, 1, device).clamp(0, 1)
    return Views(viewmat=torch.stack(mats).to(device),
                 K=torch.stack(Ks).to(device),
                 center=torch.tensor(centers, dtype=torch.float32,
                                     device=device),
                 image=image, alpha_mask=alpha, invdepth=invdepth,
                 depth_mask=torch.ones_like(alpha), is_aerial=aerial,
                 width=W, height=H)


def cameras_extent(views: Views) -> float:
    """`getNerfppNorm`'s radius (horizongs_tpu_torch/data/readers.py::
    nerfpp_norm, commit 9bef012): 1.1 x the largest distance of a camera
    centre from their mean."""
    c = views.center.double()
    return float(torch.linalg.norm(c - c.mean(0), dim=1).max() * 1.1)
