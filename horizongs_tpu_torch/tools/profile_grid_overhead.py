"""T3's tool: the fixed cost of a block on the card.

    python -m horizongs_tpu_torch.tools.profile_grid_overhead [--device cuda]

The port of `tools/profile_grid_overhead.py`, which timed near-empty
Pallas grids to find the TPU's fixed cost per grid step. Here the kernels
of `ops/grid_overhead.py` (empty, write, one_copy: one 256-thread block
per tile, as K1 launches them) run over 255, 1020, 2040 (K1's grid at
1080p) and 4080 (K3's) blocks, with the one PyTorch call that computes
each kernel's function beside it: `Tensor.zero_()` beside write, and
`copy_` of `inst[0, 0]` expanded over the output beside one_copy. A
launch through ctypes costs the host microseconds, as much
as these kernels take on the device, so CUDA events around back-to-back
launches would time the host, and the card would idle between launches.
So each kernel is launched 50 times from a CUDA graph, back to back, each
writing launch into the next buffer of a ring that spans four times the
card's L2. Its device time is read from torch.profiler, and beside it the
time from one launch to the next (CUDA events around the replay), which
also counts the write-back from L2 that outlives a writing kernel; the
host's time per launch from the stream is reported too. It needs a card.
"""
from __future__ import annotations

import argparse
import itertools
import json

import torch

from horizongs_tpu_torch.ops import grid_overhead as go

CALLS = 50        # launches per CUDA graph


def ring_size(n_blocks: int, device) -> int:
    """Output buffers of n_blocks blocks that span four times the card's
    L2 (at least 2). Launches that write them in turn find none of their
    own lines in L2; one buffer written again and again would keep part of
    itself there, and the kernel would write it faster than HBM takes the
    bytes."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(2, -(-4 * l2 // (n_blocks * go.ROWS * go.P * 4)))


def graph_times(fn) -> dict:
    """CALLS calls of `fn` replayed back to back from a CUDA graph, per
    call: "kernel_us", its kernels' device time (torch.profiler, each
    kernel's own start and end), "launch_us", the time from one call to
    the next (CUDA events around a replay, best of 3), and "kernels",
    their names. A writing kernel ends when its last stores reach L2,
    which writes them back to HBM later, in the gap before the next launch
    or during it: so a kernel's own time can be under the time HBM takes
    its bytes, while launch_us counts every byte but the last launch's
    (under 1% of 50 launches)."""
    from horizongs_tpu_torch.tools.timing import (
        best_ms, device_profile, graphed)
    replay = graphed(fn, CALLS)
    launch_ms = best_ms(replay, iters=1)
    prof = device_profile(replay)
    return {"kernel_us": prof["busy_ms"] * 1e3 / CALLS,
            "launch_us": launch_ms * 1e3 / CALLS,
            "kernels": sorted(prof["by_name"])}


def overhead_table(device) -> list:
    """Per grid of `go.GRIDS`: the device us of empty, write, one_copy,
    zero_() and copy_ (one_copy's function: every slab filled with
    inst[0, 0]), each kernel's own ("device_us", and per block) and from one
    launch to the next ("launch_us") (`graph_times`, each writing launch
    on the next buffer of a `ring_size` ring), and the host's us per
    launch of each from the stream."""
    from horizongs_tpu_torch.tools.timing import host_us_per_call
    inst = torch.zeros((go.ROWS, 4096), dtype=torch.float32, device=device)

    def fill(out):
        return out.copy_(inst[0, 0].expand_as(out))
    rows = []
    for n in go.GRIDS:
        ring = [torch.empty((n, go.ROWS, go.P), dtype=torch.float32,
                            device=device)
                for _ in range(ring_size(n, device))]
        nxt = itertools.cycle(ring).__next__
        fns = {"empty": lambda: go.empty(n, device),
               "write": lambda: go.write(nxt()),
               "one_copy": lambda: go.one_copy(inst, nxt()),
               "zero_": lambda: nxt().zero_(),
               "copy_": lambda: fill(nxt())}
        row = {"blocks": n, "ring": len(ring)}
        for name, fn in fns.items():
            t = graph_times(fn)
            row[name] = {"device_us": t["kernel_us"],
                         "device_us_per_block": t["kernel_us"] / n,
                         "launch_us": t["launch_us"],
                         "host_us_per_launch": host_us_per_call(fn),
                         "kernels": t["kernels"]}
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from horizongs_tpu_torch.tools.timing import require_cuda
    dev = require_cuda(a.device)
    rows = overhead_table(dev)
    for r in rows:
        cells = []
        for k in ("empty", "write", "one_copy", "zero_", "copy_"):
            c = r[k]
            cells.append(f"{k} {c['device_us']:8.2f} us "
                         f"({c['device_us_per_block']:.4f}/block, launch "
                         f"to launch {c['launch_us']:.2f}, host "
                         f"{c['host_us_per_launch']:.1f})")
        print(f"blocks {r['blocks']:5d}: " + "  ".join(cells))
    print(json.dumps({"tool": "profile_grid_overhead", "device": str(dev),
                      "card": torch.cuda.get_device_name(dev),
                      "table": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
