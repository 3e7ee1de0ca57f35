"""T3: kernels that do (almost) nothing per block, to measure the fixed
cost of a block on the card (`csrc/grid_overhead.cu`).

The counterpart of the Pallas tool `tools/profile_grid_overhead.py`
(`null_kernel`, `one_dma_kernel`), with one 256-thread block per tile as
K1 launches them:
  empty     no body: the launch and block-scheduling floor;
  write     the null kernel's function: zero each block's (16, 1024)
            float32 output block;
  one_copy  the one-DMA kernel's: read inst[:, 0:128] of a (16, cols)
            input, then write zeros plus inst[0, 0].
The plain versions are `torch.zeros` and its broadcast; for CPU tensors
the wrappers run them. `Tensor.zero_()` on the same buffer computes
`write`'s function in one PyTorch call.
"""
from __future__ import annotations

import ctypes

import torch

from horizongs_tpu_torch.kernels import CudaKernel

ROWS = 16          # the TPU kernels' output block: (16, 1024) float32
P = 1024
COPY_COLS = 128
GRIDS = (255, 1020, 2040, 4080)   # K1's grid at 1080p is 2040, K3's 4080

_VP, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL_EMPTY = CudaKernel("grid_overhead_empty", [_INT, _VP],
                          source="grid_overhead")
KERNEL_WRITE = CudaKernel("grid_overhead_write", [_INT, _VP, _VP],
                          source="grid_overhead")
KERNEL_ONE_COPY = CudaKernel("grid_overhead_one_copy",
                             [_INT, _VP, _INT, _VP, _VP],
                             source="grid_overhead")
KERNELS = {"empty": KERNEL_EMPTY, "write": KERNEL_WRITE,
           "one_copy": KERNEL_ONE_COPY}


def write_plain(n_blocks: int, device) -> torch.Tensor:
    return torch.zeros((n_blocks, ROWS, P), dtype=torch.float32,
                       device=device)


def one_copy_plain(inst: torch.Tensor, n_blocks: int) -> torch.Tensor:
    return write_plain(n_blocks, inst.device) + inst[0, 0]


def _check_out(out: torch.Tensor) -> int:
    if (out.dtype != torch.float32 or out.dim() != 3
            or tuple(out.shape[1:]) != (ROWS, P) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous (n, {ROWS}, {P}) float32 "
                         f"tensor, got {tuple(out.shape)} {out.dtype}")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"T3 runs on cuda or cpu, not {out.device}")
    return out.shape[0]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def empty(n_blocks: int, device) -> None:
    """Launch `n_blocks` empty blocks (nothing on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cpu" or n_blocks == 0:
        return
    with torch.cuda.device(dev):
        KERNEL_EMPTY.launch(n_blocks, _stream(dev))


def write(out: torch.Tensor) -> torch.Tensor:
    """Zero `out` (n, 16, 1024), one block per (16, 1024) slab."""
    n = _check_out(out)
    if out.device.type == "cpu":
        return out.copy_(write_plain(n, out.device))
    if n:
        with torch.cuda.device(out.device):
            KERNEL_WRITE.launch(n, out.data_ptr(), _stream(out.device))
    return out


def one_copy(inst: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Each block reads inst[:, 0:128], then writes zeros plus inst[0, 0]
    into its slab of `out`."""
    n = _check_out(out)
    if (inst.dtype != torch.float32 or inst.dim() != 2
            or inst.shape[0] != ROWS or inst.shape[1] < COPY_COLS
            or not inst.is_contiguous() or inst.device != out.device):
        raise ValueError(f"inst must be a contiguous ({ROWS}, >= {COPY_COLS}) "
                         f"float32 tensor on {out.device}")
    if out.device.type == "cpu":
        return out.copy_(one_copy_plain(inst, n))
    if n:
        with torch.cuda.device(out.device):
            KERNEL_ONE_COPY.launch(n, inst.data_ptr(), inst.shape[1],
                                   out.data_ptr(), _stream(out.device))
    return out
