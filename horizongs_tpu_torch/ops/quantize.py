"""The viewer's frame quantize on the card (`csrc/quantize_u8.cu`): an
(H, W, 3) float32 render on the card -> the uint8 frame sent, in pinned
host memory.

The plain version is `viewer.server.quantize` (numpy's clip, x 255 and
cast), which the viewer keeps for arrays and CPU tensors; the kernel gives
its bytes exactly. `FrameQuantizer` holds, for each (device, H, W), a
device uint8 buffer, a pinned host buffer and an event: the kernel writes
the frame on the current stream, after the render's kernels, one
non-blocking copy brings its bytes to the host, and the host waits on the
event recorded after the copy.

The buffers are reused frame after frame, and the array returned is a
view of the pinned buffer: it holds the frame until the next call for the
same resolution. The viewer sends it (`sendall` returns once the bytes
are handed to the socket) before it quantizes the next frame.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from horizongs_tpu_torch.kernels import CudaKernel

_VP = ctypes.c_void_p
KERNEL = CudaKernel("quantize_u8", [_VP, _VP, ctypes.c_longlong, _VP])


class FrameQuantizer:
    """The card's quantize with its buffers, one set per (device, H, W)."""

    def __init__(self):
        self.buffers = {}

    def __call__(self, image: torch.Tensor) -> np.ndarray:
        """(H, W, 3) float32 on the card -> the (H, W, 3) uint8 frame, a
        view of this resolution's pinned buffer."""
        if (not torch.is_tensor(image) or image.device.type != "cuda"
                or image.dtype != torch.float32 or image.dim() != 3
                or image.shape[2] != 3):
            got = (f"{tuple(image.shape)} {image.dtype} on {image.device}"
                   if torch.is_tensor(image) else type(image).__name__)
            raise ValueError("the card's quantize takes an (H, W, 3) float32 "
                             f"CUDA tensor, got {got}")
        x = image.detach().contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        key = (x.device, x.shape[0], x.shape[1])
        bufs = self.buffers.get(key)
        if bufs is None:
            bufs = self.buffers[key] = (
                torch.empty(x.shape, dtype=torch.uint8, device=x.device),
                torch.empty(x.shape, dtype=torch.uint8, pin_memory=True),
                torch.cuda.Event())
        dev, host, done = bufs
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device)
            KERNEL.launch(x.data_ptr(), dev.data_ptr(), x.numel(),
                          stream.cuda_stream)
            host.copy_(dev, non_blocking=True)
            done.record(stream)
        done.synchronize()
        return host.numpy()

