"""P1, the 3DGS projection (`csrc/project3d.cu`), checked and timed on the
card.

    python -m horizongs_tpu_torch.tools.profile_project [--rows N]

Over `rows` rows (10,035,200 by default: a table of 1,003,520 anchors x
10 offsets) of random splats around a 1600x900 view, it first holds P1
to the plain path: the forward's fields, radii and cull radii bit for bit
(`forward_mismatch`), and the backward's error against the plain path in
float64, leaf by leaf, at most twice the plain float32 path's
(`backward_errors`, the field gradient a fixed random tensor). Then it
times P1's forward and backward (`ops/project3d.ProjectFields3D`) and the
plain path's forward and backward (`project_fields_3dgs_plain` under
autograd) with CUDA events, the best mean of 20 calls over 3 rounds after
a warm-up (`tools/timing.best_ms`), beside the bytes bound: the least
bytes each direction must move over 3.35 TB/s (forward 56 B read and
48 B written a row, backward 80 B read and 56 B written; the probe's 8 B
each way not counted). It prints ptxas's registers and spills from a
fresh build, and one JSON line. It needs a card."""
from __future__ import annotations

import argparse
import json

import torch

BYTES_FWD = 56 + 48
BYTES_BWD = 80 + 56
HBM_BYTES_PER_S = 3.35e12
LEAVES = ("means", "quats", "scales", "opacities", "rgb", "means2d_probe")


def _rows(rows: int, dev, seed: int = 1):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo
    means = u(rows, 3, lo=-2.0, hi=2.0)
    quats = torch.randn(rows, 4, device=dev, generator=g)
    scales = torch.exp(u(rows, 3, lo=-6.0, hi=-1.0))
    return [means, quats, scales, u(rows), u(rows, 3),
            torch.zeros(rows, 2, device=dev)]


def _same(a, b):
    """Rows that differ (NaN equal to NaN) and the largest difference."""
    diff = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    if diff.dim() > 1:
        diff = diff.any(dim=1)
    big = (a.double() - b.double()).abs().nan_to_num(0.0).max().item()
    return int(diff.sum()), big


def forward_mismatch(kern, plain) -> dict:
    """{fields, radii, cull: (rows that differ, largest difference)}
    between two `ProjectedFields`."""
    return {name: _same(getattr(kern, name), getattr(plain, name))
            for name in ("fields", "radii", "cull")}


def _grads(inputs, cam, w, h, cot, dtype, card):
    """Every leaf's gradient of <fields, cot>: through
    `project_fields_3dgs` (P1 on the card) where `card`, else through the
    plain path, in `dtype`."""
    from horizongs_tpu_torch.ops import project3d
    leaves = [x.to(dtype).clone().requires_grad_(True) for x in inputs]
    project = (project3d.project_fields_3dgs if card
               else project3d.project_fields_3dgs_plain)
    fields = project(*leaves[:4], lambda: leaves[4], cam.viewmat.to(dtype),
                     cam.K.to(dtype), w, h, leaves[5]).fields
    return torch.autograd.grad(fields, leaves, cot.to(dtype))


def backward_errors(inputs, cam, w, h, seed: int, row_sets=None) -> dict:
    """{row set: {leaf: (P1's error, the plain float32 path's error,
    P1's largest difference)}} against the plain path in float64: the norm
    of the difference over the norm of the float64 gradient, over each of
    `row_sets` ({"all": every row} by default), for a random field
    gradient from `seed`. Every P1 gradient must be finite."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    cot = torch.randn((inputs[0].shape[0], 10), generator=gen,
                      device=inputs[0].device)
    kern = _grads(inputs, cam, w, h, cot, torch.float32, True)
    plain = _grads(inputs, cam, w, h, cot, torch.float32, False)
    exact = _grads(inputs, cam, w, h, cot, torch.float64, False)
    out = {}
    for label, rows in (row_sets or {"all": slice(None)}).items():
        report = {}
        for name, k, p, e in zip(LEAVES, kern, plain, exact):
            if not bool(torch.isfinite(k).all()):
                raise ValueError(f"P1's {name} gradient is not finite")
            k, p, e = k[rows].double(), p[rows].double(), e[rows]
            scale = e.norm().item()
            report[name] = ((k - e).norm().item() / scale,
                            (p - e).norm().item() / scale,
                            (k - e).abs().max().item())
        out[label] = report
    return out


def within_twice_plain(errors: dict) -> bool:
    """Every leaf's P1 error at most twice the plain float32 path's."""
    return all(k <= 2.0 * p for rep in errors.values()
               for k, p, _ in rep.values())


@torch.enable_grad()
def profile_project(rows: int = 10_035_200, device="cuda") -> dict:
    """P1 against the plain path over `rows` rows (`forward_mismatch`,
    `backward_errors`), then P1's and the plain path's forward and
    backward ms, the bytes bounds and P1's share of them."""
    from horizongs_tpu_torch.data.synthetic import lookat_camera
    from horizongs_tpu_torch.ops import project3d
    from horizongs_tpu_torch.tools.timing import best_ms, require_cuda
    dev = require_cuda(device)
    w, h = 1600, 900
    cam = lookat_camera(width=w, height=h, eye=(0.0, -1.0, -5.0), device=dev)
    inputs = _rows(rows, dev)
    with torch.no_grad():
        fwd_off = forward_mismatch(
            project3d.project_fields_3dgs(
                *inputs[:4], lambda: inputs[4], cam.viewmat, cam.K, w, h,
                inputs[5]),
            project3d.project_fields_3dgs_plain(
                *inputs[:4], lambda: inputs[4], cam.viewmat, cam.K, w, h,
                inputs[5]))
    bwd_err = backward_errors(inputs, cam, w, h, seed=3)

    leaves = [x.requires_grad_() for x in inputs]
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    cot = torch.randn(rows, 10, device=dev, generator=g)
    args = (*leaves[:5], leaves[5], cam.viewmat, cam.K, w, h)

    def kern_fwd():
        with torch.no_grad():
            project3d.ProjectFields3D.apply(*args)

    def plain_fwd():
        with torch.no_grad():
            project3d.project_fields_3dgs_plain(
                *leaves[:4], lambda: leaves[4], cam.viewmat, cam.K, w, h,
                leaves[5])

    def backward_of(make):
        fields = make()

        def run():
            torch.autograd.grad(fields, leaves, cot, retain_graph=True)
        return run

    out = {"rows": rows, "forward_rows_off": fwd_off,
           "backward_errors": bwd_err["all"],
           "fwd_ms": best_ms(kern_fwd), "plain_fwd_ms": best_ms(plain_fwd,
                                                                iters=5)}
    run = backward_of(lambda: project3d.ProjectFields3D.apply(*args)[0])
    out["bwd_ms"] = best_ms(run)
    run = backward_of(lambda: project3d.project_fields_3dgs_plain(
        *leaves[:4], lambda: leaves[4], cam.viewmat, cam.K, w, h,
        leaves[5]).fields)
    out["plain_bwd_ms"] = best_ms(run, iters=5)
    del run
    out["bound_fwd_ms"] = rows * BYTES_FWD / HBM_BYTES_PER_S * 1e3
    out["bound_bwd_ms"] = rows * BYTES_BWD / HBM_BYTES_PER_S * 1e3
    out["fwd_pct"] = 100.0 * out["bound_fwd_ms"] / out["fwd_ms"]
    out["bwd_pct"] = 100.0 * out["bound_bwd_ms"] / out["bwd_ms"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_035_200)
    args = ap.parse_args(argv)
    from horizongs_tpu_torch.kernels import build
    b = build("project3d")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    out = profile_project(args.rows)
    print(json.dumps(out))
    if any(n for n, _ in out["forward_rows_off"].values()):
        raise SystemExit("P1's forward differs from the plain path")
    if not within_twice_plain({"all": out["backward_errors"]}):
        raise SystemExit("P1's backward is further from float64 than twice "
                         "the plain path")


if __name__ == "__main__":
    main()
