"""Build, load and count the package's CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with a plain C entry point; it
may include the headers `csrc/*.cuh`. At first use it is compiled with
`nvcc` for Hopper (`sm_90a`) into a shared library under `build/kernels/`
at the checkout root (listed in `.gitignore`), named by the hash of the
source, the headers and the flags, so an edited source or header is
rebuilt. A build may add preprocessor defines (`-D`), which also go
into the hash: one source then gives several libraries (the K2 variants
of `ops/raster3d.py::rasterize_bwd_variant`); a build without defines
runs the same nvcc command as before defines existed. The library is
loaded with `ctypes`; pointers and the stream go across as `c_void_p`. A
missing `nvcc`, a failed build or a non-zero return from a launch raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildResult(NamedTuple):
    path: Path
    seconds: float       # 0.0 when the library was already built
    log: str             # nvcc's output (ptxas register / spill report)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def build(name: str, defines: Sequence[str] = ()) -> BuildResult:
    """Compile `csrc/<name>.cu`, with `-D<d>` for each of `defines` (such
    as "K2_VARIANT=1"), unless the library for its current source, headers
    and flags is already there."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


class CudaKernel:
    """The C entry point `name` of `csrc/<source>.cu` (`source` defaults to
    `name`) built with `defines`, loaded at first launch.

    `launches` counts the calls of `launch`, i.e. the kernel launches the
    wrapper asked for; a caller may reset it to 0 to count a run. `call`
    runs an entry point that launches nothing (a query of the card) and
    counts nothing."""

    def __init__(self, name: str, argtypes: Sequence,
                 source: Optional[str] = None, defines: Sequence[str] = ()):
        self.name = name
        self.source = source or name
        self.defines = tuple(defines)
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def build(self) -> BuildResult:
        return build(self.source, self.defines)

    def _load(self):
        lib = ctypes.CDLL(str(self.build().path))
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib = lib        # keep the library mapped while fn lives
        return fn

    def call(self, *args) -> None:
        if self._fn is None:
            self._fn = self._load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA call failed with "
                               f"cudaError {err}")

    def launch(self, *args) -> None:
        self.call(*args)
        self.launches += 1
