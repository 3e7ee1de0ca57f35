"""ctypes binding of the native data plane (`native/src/hgs_io.cpp`).

The JAX package's `native/__init__.py`: JPEG/PNG decode (libjpeg,
libpng), the antialiased resize and the float normalisation in C++, a
prefetch pool of C++ threads, and the COLMAP `points3D.bin` parser. The
ctypes calls release the GIL, so the callers' Python threads overlap.

The source is the repository's `native/src/hgs_io.cpp`, read and never
written. At first use it is compiled with `g++` and the flags of
`native/Makefile` into `build/native/` at the checkout root (listed in
`.gitignore`), named by a digest of the source, the compiler and the
flags. One process compiles under a file lock into a temporary name and
renames it into place, so processes that import this module together
never load a partial library. When the compiler, libjpeg or libpng is
missing, `available()` is false, `unavailable_reason()` holds the
compiler's last lines, the reason is logged once, and the callers decode
through PIL as the JAX package does: the decoder is a host library, not a
device kernel.

API (the JAX binding's names):
  available() -> bool
  unavailable_reason() -> str | None
  image_info(path) -> (w, h, channels)
  load_image_rgba(path, tw, th) -> float32 ndarray (th, tw, 4) in [0, 1]
  read_colmap_points3d(path) -> (ids int64, xyz float64, rgb uint8,
                                 err float64)
  ImagePool(n_threads).load_many([(path, tw, th), ...]) -> [ndarray]
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "src" / "hgs_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX = "g++"
# native/Makefile's CXXFLAGS, -shared and LDLIBS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
NATIVE_FORMATS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
# the process's library, or the reason it has none (set once, under _lock)
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current source, compiler and flags
    lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (CXX, *CXX_FLAGS, *LIBS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhgs_io-{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; raises RuntimeError with
    the compiler's last lines when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if out.exists():                     # another process built it
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{CXX}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            tail = "\n".join((proc.stderr or proc.stdout).strip()
                             .splitlines()[-8:])
            raise RuntimeError(f"{CXX} exited {proc.returncode}: {tail}")
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, c, f = ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    sigs = {
        "hgs_image_info": ([c, ctypes.POINTER(i), ctypes.POINTER(i),
                            ctypes.POINTER(i)], i),
        "hgs_load_resize_rgba": ([c, i, i, f], i),
        "hgs_pool_create": ([i], vp),
        "hgs_pool_submit": ([vp, c, i, i, f], i),
        "hgs_pool_wait": ([vp, i], i),
        "hgs_pool_destroy": ([vp], None),
        "hgs_colmap_points3d_count": ([c, ctypes.POINTER(ll)], i),
        "hgs_colmap_points3d_read": (
            [c, ll, ctypes.POINTER(ll), ctypes.POINTER(ctypes.c_double),
             ctypes.POINTER(ctypes.c_uint8),
             ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ll)], i),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    with _lock:
        if _lib is None and _reason is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _reason = str(e)
                _log.warning("native image loader unavailable, images "
                             "decode through PIL: %s", _reason)
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None when it is
    available)."""
    _load()
    return _reason


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native hgs_io not available: {_reason}")
    return lib


def image_info(path: str) -> Tuple[int, int, int]:
    """(width, height, channels) from the file's header."""
    lib = _require()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.hgs_image_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c))
    if rc != 0:
        raise IOError(f"hgs_image_info({path}) failed: {rc}")
    return w.value, h.value, c.value


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_image_rgba(path: str, tw: int, th: int) -> np.ndarray:
    """Decode and antialiased-resize to (th, tw, 4) float32 RGBA in
    [0, 1]."""
    lib = _require()
    out = np.empty((th, tw, 4), dtype=np.float32)
    rc = lib.hgs_load_resize_rgba(path.encode(), tw, th, _f32_ptr(out))
    if rc != 0:
        raise IOError(f"hgs_load_resize_rgba({path}) failed: {rc}")
    return out


def read_colmap_points3d(path: str):
    """Parse COLMAP points3D.bin: one read and a pointer walk. Returns
    (ids int64 (N,), xyz float64 (N, 3), rgb uint8 (N, 3), err float64
    (N,))."""
    lib = _require()
    n = ctypes.c_longlong()
    rc = lib.hgs_colmap_points3d_count(path.encode(), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"points3d count({path}) failed: {rc}")
    n = n.value
    ids = np.empty(n, dtype=np.int64)
    xyz = np.empty((n, 3), dtype=np.float64)
    rgb = np.empty((n, 3), dtype=np.uint8)
    err = np.empty(n, dtype=np.float64)
    track_total = ctypes.c_longlong()
    rc = lib.hgs_colmap_points3d_read(
        path.encode(), n,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(track_total))
    if rc != 0:
        raise IOError(f"points3d read({path}) failed: {rc}")
    return ids, xyz, rgb, err


class ImagePool:
    """Decode and resize jobs on C++ worker threads (0: one a core), into
    buffers numpy owns (no copy back). A context manager; `close` joins
    the threads."""

    def __init__(self, n_threads: int = 0):
        self._lib = _require()
        self._pool = self._lib.hgs_pool_create(n_threads)
        self._bufs: List[np.ndarray] = []

    def submit(self, path: str, tw: int, th: int) -> int:
        out = np.empty((th, tw, 4), dtype=np.float32)
        ticket = self._lib.hgs_pool_submit(self._pool, path.encode(), tw, th,
                                           _f32_ptr(out))
        if ticket != len(self._bufs):
            raise RuntimeError(f"native pool: ticket {ticket}, expected "
                               f"{len(self._bufs)}")
        self._bufs.append(out)      # alive while the workers write it
        return ticket

    def get(self, ticket: int) -> np.ndarray:
        rc = self._lib.hgs_pool_wait(self._pool, ticket)
        if rc != 0:
            raise IOError(f"native image load failed (ticket {ticket}): "
                          f"{rc}")
        return self._bufs[ticket]

    def load_many(self, jobs: Sequence[Tuple[str, int, int]]
                  ) -> List[np.ndarray]:
        tickets = [self.submit(*j) for j in jobs]
        return [self.get(t) for t in tickets]

    def close(self) -> None:
        if self._pool is not None:
            self._lib.hgs_pool_destroy(self._pool)
            self._pool = None
            self._bufs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()
