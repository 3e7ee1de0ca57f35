"""Horizon-GS on PyTorch and CUDA: the Hopper port of `horizongs_tpu`.

The JAX package beside this one is the reference. This package mirrors its
module names so that each piece has a counterpart there, imports nothing of
it, and replaces each Pallas TPU kernel with a CUDA kernel written for
Hopper (`csrc/`). Every kernel keeps a plain PyTorch version beside it: a
wrapper takes the plain version only for tensors that lie on the CPU.

Layer map (bottom -> top):
  device.py  default device (cuda, or raise) and TF32 switches
  config.py  the YAML config's three namespaces and their defaults
  core/      cameras, rotations, spherical harmonics
  io/        PLY codec, anchor and explicit PLYs, MLP weights, training
             checkpoints
  data/      dataset readers (Blender, COLMAP, city, UCGS), camera loading,
             the scene, synthetic scenes and the synthetic dataset writer,
             chunk partitioning, depth back-projection and scale fits
  models/    model config, MLP decoders, anchor tables and LOD decode, the
             explicit (SH-baked) model
  ops/       projection, tile binning, dense oracles, the 3DGS compositors
             K1/K2 (`ops/raster3d.py` + `csrc/raster3d_*.cu`), the 2DGS
             compositors K3/K4 (`ops/raster2d.py` + `csrc/raster2d_*.cu`),
             their wrappers (`ops/raster_cuda.py`)
  kernels.py nvcc build, load and launch count of the CUDA sources
  render.py  the serving entry point: camera + model -> images
  train/     losses, schedules, Adam, the training step, densification,
             the trainer, the evaluation and LPIPS
  utils/     fly-through paths, TSDF fusion and mesh extraction, vis
  viewer/    the SIBR network-GUI viewer server
  parallel/  chunk configs, chunk jobs and the streaming chunk merge
  cli/       train, render, metrics, view, export_mesh, convert, partition,
             merge, generate_depth and the synthetic dataset writer
  convert.py the JAX package's parameters (as numpy) -> this package
"""

__version__ = "0.1.0"
