"""T1's tool: K1 against its persistent form, on the equal-L workload.

    python -m horizongs_tpu_torch.tools.fused_fwd [--iters 20]
        [--n_tiles_x 60] [--n_tiles_y 34] [--device cuda]

The port of `tools/experiment_fused_fwd.py`, which on the TPU compared a
fused-grid forward (the whole tile grid walked in one grid step) with the
per-tile-grid kernel. On Hopper the comparison is one of schedules for
the same per-tile walk: K1 (one block per tile, the hardware's block
scheduler) against T1 (`ops/raster3d.py::rasterize_fwd_persistent`,
persistent blocks) with a static and a dynamic schedule. For each L in
(1, 2, 4, 16) every tile gets L chunks of G = 128 gaussians, drawn with
the JAX tool's numpy draws in its order (its (16, CAP+2G) instance columns
become (N, 10) fields with gauss_id = arange and tile_starts =
arange(T+1)·L·G). Each schedule is first checked against K1 for exact
equality of acc, log T, i_fin and n_contrib, then K1 and both schedules
are timed (CUDA events, best of 3 x `iters`); the tool prints ms and us
per chunk (T x L chunks). It needs a card; with `--device cpu` it runs
only the equality checks (all three are then K1's plain version).
"""
from __future__ import annotations

import argparse
import json
from typing import Iterator, Tuple

import numpy as np
import torch

from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops.raster3d import G, TILE_H, TILE_W

SWEEP = (1, 2, 4, 16)


def equal_l_workloads(n_tiles_x: int, n_tiles_y: int, Ls=SWEEP,
                      seed: int = 0
                      ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """(L, fields (T·L·G, 10) float32, tile_starts (T+1,) int32) for each
    L, drawn from one `default_rng(seed)` in the JAX tool's order
    (`tools/experiment_fused_fwd.py:182-196`): x and y uniform over the
    image, conic (0.02, 0, 0.02), opacity 0.005, rgb uniform in [0, 1),
    depth uniform in [1, 10)."""
    n_tiles = n_tiles_x * n_tiles_y
    rng = np.random.default_rng(seed)
    for L in Ls:
        cap = n_tiles * L * G
        f = np.zeros((cap, raster3d.N_FIELDS), np.float32)
        f[:, 0] = rng.uniform(0, n_tiles_x * TILE_W, cap)
        f[:, 1] = rng.uniform(0, n_tiles_y * TILE_H, cap)
        f[:, 2] = 0.02
        f[:, 4] = 0.02
        f[:, 5] = 0.005
        f[:, 6:9] = rng.uniform(0, 1, (3, cap)).T
        f[:, 9] = rng.uniform(1, 10, cap)
        yield L, f, (np.arange(n_tiles + 1) * L * G).astype(np.int32)


def workload_args(fields: np.ndarray, tile_starts: np.ndarray,
                  n_tiles_x: int, n_tiles_y: int, device) -> tuple:
    """The K1 arguments of one workload on `device`: every instance is its
    own gaussian (gauss_id = arange)."""
    dev = torch.device(device)
    return (torch.from_numpy(fields).to(dev),
            torch.arange(fields.shape[0], dtype=torch.int32, device=dev),
            torch.from_numpy(tile_starts).to(dev), n_tiles_x, n_tiles_y)


def mismatches(a, b) -> int:
    """Elements of (acc, logT, n_contrib) that differ between two runs,
    bit for bit (NaN never appears in either)."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def check_schedules(args, launches: int = 2) -> dict:
    """Each schedule of T1 launched `launches` times on K1's arguments:
    the elements that differ from K1's outputs, per schedule and launch."""
    ref = raster3d.rasterize_fwd(*args)
    return {s: [mismatches(raster3d.rasterize_fwd_persistent(
        *args, schedule=s), ref) for _ in range(launches)]
        for s in raster3d.SCHEDULES}


def time_schedules(args, iters: int = 20) -> dict:
    """ms of K1 and of each T1 schedule on `args` (best of 3 x iters), and
    T1's grid."""
    from horizongs_tpu_torch.tools.timing import best_ms
    out = {"k1": best_ms(lambda: raster3d.rasterize_fwd(*args), iters)}
    for s in raster3d.SCHEDULES:
        out[s] = best_ms(lambda: raster3d.rasterize_fwd_persistent(
            *args, schedule=s), iters)
    out["grid"] = raster3d.persistent_grid(args[3] * args[4], "dynamic",
                                           args[0].device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n_tiles_x", type=int, default=60)
    ap.add_argument("--n_tiles_y", type=int, default=34)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        from horizongs_tpu_torch.tools.timing import require_cuda
        require_cuda(dev)
    n_tiles = a.n_tiles_x * a.n_tiles_y
    rows = []
    for L, f, starts in equal_l_workloads(a.n_tiles_x, a.n_tiles_y):
        args = workload_args(f, starts, a.n_tiles_x, a.n_tiles_y, dev)
        row = {"L": L, "mismatches": check_schedules(args)}
        if any(n for ns in row["mismatches"].values() for n in ns):
            raise AssertionError(f"T1 differs from K1 at L={L}: "
                                 f"{row['mismatches']}")
        if dev.type == "cuda":
            row.update(time_schedules(args, a.iters))
            chunks = n_tiles * L
            print(f"L={L:2d}: " + "  ".join(
                f"{k} {row[k]:8.4f} ms ({row[k] * 1e3 / chunks:6.4f} "
                f"us/chunk)" for k in ("k1", *raster3d.SCHEDULES)))
        rows.append(row)
    print(json.dumps({"tool": "fused_fwd", "n_tiles": n_tiles,
                      "device": str(dev), "sweep": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
