"""The 3DGS projection packed into K1's field row, as one differentiable
step: P1 (`csrc/project3d.cu`, forward and backward) for CUDA inputs,
the plain path for CPU inputs.

`project_fields_3dgs(means, quats, scales, opacities, rgb, viewmat, K,
width, height, means2d_probe=None)` returns `ProjectedFields`:
  * `fields` (N, 10) float32, contiguous: [mx, my, conic a, b, c,
    opacity, r, g, b, depth], the probe added to mx, my (see
    `ops/raster_cuda.build_raster_inputs`); `rgb` is a function that
    returns the (N, 3) colours (see below), or None for zero colour
    columns (a count needs no colour);
  * `radii` (N,): the geometric radius, 0 where culled, which the
    densification statistics read;
  * `cull` (N,): binning's cull radius (`_cull_radii`), 0 below the
    alpha cutoff.
`proj` views the field columns as `ProjectedGaussians` (radii, means2d,
depths, conics). Only `fields` carries a gradient; `viewmat` and `K` take
none, and a camera that requires one is refused.

The plain path is `ops/projection.project_3dgs`, `_cull_radii` and a cat:
the CPU tests' path and the oracle of the card test. On the card the
forward kernel reproduces it bit for bit, and the backward recomputes the
forward from means, quats and scales (the only tensors the step saves,
with the camera) and returns every input's gradient in one pass, where
autograd would replay about 190 nodes over row-sized intermediates.
Which path runs follows from the inputs: CUDA means take the kernels,
with every tensor checked (float32, contiguous, on the same card, of its
shape) and anything else refused; CPU means take the plain path.

The colour function is called after the plain path's projection and
before its packing, so that the colours' autograd nodes come after the
projection's, as they did when the projection was a step of its own:
the means' gradient then sums its parts in the same order, and rounds as
it did (the SH colours read the means too). The kernels call it first.

While the recorder of `horizongs_tpu_torch.tracing` is on, the
projection is the span `render.project` (on the card P1's forward, with
the cull and the packing; on the plain path `project_3dgs`), outside
which the colour function runs (its own span `render.sh` stays a child
of the caller's), and each call counts its rows in `render.project_rows`
and, for the kernels, in `render.project_rows_card`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.kernels import CudaKernel
from horizongs_tpu_torch.ops.binning import cull_radius
from horizongs_tpu_torch.ops.projection import ProjectedGaussians, project_3dgs
from horizongs_tpu_torch.ops.reference import ALPHA_CUTOFF

N_FIELDS = 10

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("project3d_fwd",
                    [_VP] * 8 + [_INT, _INT, _LL] + [_VP] * 4,
                    source="project3d")
KERNEL_BWD = CudaKernel("project3d_bwd",
                        [_VP] * 5 + [_INT, _INT, _LL] + [_VP] * 8,
                        source="project3d")


class ProjectedFields(NamedTuple):
    fields: torch.Tensor    # (N, 10) float32
    radii: torch.Tensor     # (N,) geometric radius, 0 => culled
    cull: torch.Tensor      # (N,) binning's cull radius

    @property
    def proj(self) -> ProjectedGaussians:
        """The projection's outputs as views of the field columns."""
        f = self.fields
        return ProjectedGaussians(radii=self.radii, means2d=f[:, 0:2],
                                  depths=f[:, 9], conics=f[:, 2:5])


def _cull_radii(proj, opacities: torch.Tensor, guard_px: float = 0.0):
    # gaussians below the alpha cutoff can never contribute: not binned
    return torch.where(opacities >= ALPHA_CUTOFF,
                       cull_radius(proj.radii, opacities, guard_px=guard_px),
                       torch.zeros_like(proj.radii))


def project_fields_3dgs_plain(means, quats, scales, opacities, rgb, viewmat,
                              K, width: int, height: int,
                              means2d_probe=None) -> ProjectedFields:
    """The plain path: `project_3dgs` (the span `render.project`), the
    colour function, the cull and the packing."""
    with tracing.span("render.project"):
        proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    cull = _cull_radii(proj, opacities)
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    rgb = opacities.new_zeros((opacities.shape[0], 3)) if rgb is None \
        else rgb()
    fields = torch.cat([means2d, proj.conics, opacities[:, None], rgb,
                        proj.depths[:, None]], dim=-1).contiguous()
    return ProjectedFields(fields, proj.radii, cull)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


class ProjectFields3D(torch.autograd.Function):
    """P1's forward and backward at the boundary of `project_fields_3dgs`
    (inputs checked by `_check_card`); `radii` and `cull` carry no
    gradient."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, rgb, probe, viewmat, K,
                width, height):
        n, dev = means.shape[0], means.device
        fields = torch.empty((n, N_FIELDS), dtype=torch.float32, device=dev)
        radii = torch.empty((n,), dtype=torch.float32, device=dev)
        cull = torch.empty((n,), dtype=torch.float32, device=dev)
        if n:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                KERNEL.launch(means.data_ptr(), quats.data_ptr(),
                              scales.data_ptr(), opacities.data_ptr(),
                              _ptr(rgb), _ptr(probe), viewmat.data_ptr(),
                              K.data_ptr(), width, height, n,
                              fields.data_ptr(), radii.data_ptr(),
                              cull.data_ptr(), stream)
        ctx.save_for_backward(means, quats, scales, viewmat, K)
        ctx.size = (width, height)
        ctx.mark_non_differentiable(radii, cull)
        return fields, radii, cull

    @staticmethod
    def backward(ctx, d_fields, _d_radii, _d_cull):
        means, quats, scales, viewmat, K = ctx.saved_tensors
        need = ctx.needs_input_grad
        n, dev = means.shape[0], means.device
        g = d_fields.contiguous()
        d_means = torch.empty_like(means)
        d_quats = torch.empty_like(quats)
        d_scales = torch.empty_like(scales)
        d_op = torch.empty((n,), dtype=torch.float32, device=dev) \
            if need[3] else None
        d_rgb = torch.empty((n, 3), dtype=torch.float32, device=dev) \
            if need[4] else None
        d_probe = torch.empty((n, 2), dtype=torch.float32, device=dev) \
            if need[5] else None
        if n:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                KERNEL_BWD.launch(means.data_ptr(), quats.data_ptr(),
                                  scales.data_ptr(), viewmat.data_ptr(),
                                  K.data_ptr(), *ctx.size, n, g.data_ptr(),
                                  d_means.data_ptr(), d_quats.data_ptr(),
                                  d_scales.data_ptr(), _ptr(d_op),
                                  _ptr(d_rgb), _ptr(d_probe), stream)
        return (d_means, d_quats, d_scales, d_op, d_rgb, d_probe, None, None,
                None, None)


def _check_card(means, quats, scales, opacities, rgb, probe, viewmat, K):
    """Refuse what P1 does not take: every tensor float32, contiguous, on
    the card `means` is on, and of its shape for N rows."""
    n, dev = means.shape[0], means.device
    shapes = {"means": (means, (n, 3)), "quats": (quats, (n, 4)),
              "scales": (scales, (n, 3)), "opacities": (opacities, (n,)),
              "rgb": (rgb, (n, 3)), "means2d_probe": (probe, (n, 2)),
              "viewmat": (viewmat, (4, 4)), "K": (K, (3, 3))}
    for name, (x, shape) in shapes.items():
        if x is None and name in ("rgb", "means2d_probe"):
            continue
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def project_fields_3dgs(means, quats, scales, opacities, rgb, viewmat, K,
                        width: int, height: int,
                        means2d_probe: Optional[torch.Tensor] = None
                        ) -> ProjectedFields:
    """See the module docstring."""
    if viewmat.requires_grad or K.requires_grad:
        raise ValueError("the projection takes no gradient for viewmat or K")
    n, card = means.shape[0], means.is_cuda
    if card:
        rgb = None if rgb is None else rgb()
        _check_card(means, quats, scales, opacities, rgb, means2d_probe,
                    viewmat, K)
        with tracing.span("render.project"):
            out = ProjectedFields(*ProjectFields3D.apply(
                means, quats, scales, opacities, rgb, means2d_probe,
                viewmat, K, int(width), int(height)))
    else:
        out = project_fields_3dgs_plain(means, quats, scales, opacities, rgb,
                                        viewmat, K, width, height,
                                        means2d_probe)
    tracing.count("render.project_rows", n)
    tracing.count("render.project_rows_card", n if card else 0)
    return out
