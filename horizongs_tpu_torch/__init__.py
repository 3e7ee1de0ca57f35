"""Horizon-GS on PyTorch and CUDA: the Hopper port of `horizongs_tpu`.

The JAX package beside this one is the reference. This package mirrors its
module names so that each piece has a counterpart there, imports nothing of
it, and replaces each Pallas TPU kernel with a CUDA kernel written for
Hopper (`csrc/`). Every kernel keeps a plain PyTorch version beside it: a
wrapper takes the plain version only for tensors that lie on the CPU.

Layer map (bottom -> top):
  device.py  default device (cuda, or raise) and TF32 switches
  core/      cameras, rotations, spherical harmonics
  data/      synthetic scenes and camera rigs
  models/    model config, MLP decoders, anchor tables and LOD decode
  ops/       projection, tile binning, dense oracles, the 3DGS compositors
             K1/K2 (`ops/raster3d.py` + `csrc/raster3d_*.cu`), the 2DGS
             compositors K3/K4 (`ops/raster2d.py` + `csrc/raster2d_*.cu`),
             their wrappers (`ops/raster_cuda.py`)
  kernels.py nvcc build, load and launch count of the CUDA sources
  render.py  the serving entry point: camera + model -> images
  train/     losses, schedules, Adam, the training step
  convert.py the JAX package's parameters (as numpy) -> this package
"""

__version__ = "0.1.0"
