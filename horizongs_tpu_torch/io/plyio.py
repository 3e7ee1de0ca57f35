"""Minimal PLY codec (binary little-endian + ascii), self-contained.

A copy of `horizongs_tpu/io/plyio.py` (this package imports nothing of the
JAX package), so both packages write the same bytes; its stream writer
serves the chunk merger (`parallel/chunks.py`). Replaces the
reference's `plyfile` dependency. Supports exactly what the
framework needs: a single 'vertex' element of float32/float64/int
properties, plus `obj_info` header lines (the reference stores
standard_dist / aerial_levels / street_levels there,
`scene/lod_model.py:408-413`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "short": np.int16, "ushort": np.uint16,
    "char": np.int8, "uchar": np.uint8, "int8": np.int8, "uint8": np.uint8,
}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
          np.dtype(np.int32): "int", np.dtype(np.uint32): "uint",
          np.dtype(np.uint8): "uchar", np.dtype(np.int16): "short"}


def write_ply(path: str, props: Dict[str, np.ndarray],
              obj_info: List[str] | None = None) -> None:
    """props: ordered {name: (N,) array}; all arrays same length."""
    names = list(props.keys())
    n = len(props[names[0]])
    cols = [np.ascontiguousarray(np.asarray(props[k]).reshape(n)) for k in names]
    lines = ["ply", "format binary_little_endian 1.0"]
    for info in obj_info or []:
        lines.append(f"obj_info {info}")
    lines.append(f"element vertex {n}")
    rec_dtype = []
    for name, col in zip(names, cols):
        tname = _NAMES.get(col.dtype)
        if tname is None:
            col = col.astype(np.float32)
            tname = "float"
        lines.append(f"property {tname} {name}")
        rec_dtype.append((name, col.dtype))
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")
    rec = np.empty(n, dtype=rec_dtype)
    for name, col in zip(names, cols):
        rec[name] = col
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


class PlyStreamWriter:
    """Incremental binary PLY writer: the header goes out first (total
    row count must be known up front), then row blocks append one at a
    time — peak memory is one block, not the concatenated whole. Used by
    the chunk merger (`parallel/chunks.py`), whose reference counterpart
    (`merge.py:55-217`) concatenates every chunk in RAM."""

    def __init__(self, path: str, schema: List[Tuple[str, np.dtype]],
                 n_total: int, obj_info: List[str] | None = None):
        self._schema = [(name, np.dtype(dt)) for name, dt in schema]
        self._n = n_total
        self._written = 0
        lines = ["ply", "format binary_little_endian 1.0"]
        for info in obj_info or []:
            lines.append(f"obj_info {info}")
        lines.append(f"element vertex {n_total}")
        for name, dt in self._schema:
            lines.append(f"property {_NAMES[dt]} {name}")
        lines.append("end_header")
        self._f = open(path, "wb")
        self._f.write(("\n".join(lines) + "\n").encode("ascii"))

    def append(self, props: Dict[str, np.ndarray]) -> None:
        n = len(np.asarray(props[self._schema[0][0]]))
        rec = np.empty(n, dtype=self._schema)
        for name, dt in self._schema:
            rec[name] = np.asarray(props[name]).reshape(n).astype(dt)
        self._f.write(rec.tobytes())
        self._written += n

    def close(self) -> None:
        self._f.close()
        if self._written != self._n:
            raise ValueError(f"PlyStreamWriter: header promised {self._n} "
                             f"rows, got {self._written}")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._f.close()
        return False


def read_ply(path: str) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Returns ({name: (N,) array}, obj_info lines)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header"):]
    if body[:1] == b"\r":
        body = body[1:]
    if body[:1] == b"\n":
        body = body[1:]

    fmt = "binary_little_endian"
    obj_info: List[str] = []
    n = 0
    props: List[Tuple[str, np.dtype]] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "obj_info":
            obj_info.append(" ".join(tok[1:]))
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties not supported")
            props.append((tok[2], np.dtype(_DTYPES[tok[1]])))

    if fmt == "ascii":
        rows = body.decode("ascii").split()
        arr = np.asarray(rows[:n * len(props)], dtype=np.float64)
        arr = arr.reshape(n, len(props))
        return ({name: arr[:, i].astype(dt)
                 for i, (name, dt) in enumerate(props)}, obj_info)
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    rec = np.frombuffer(body, dtype=np.dtype(props), count=n)
    return ({name: np.ascontiguousarray(rec[name]) for name, _ in props},
            obj_info)


def read_points_ply(path: str):
    """Point cloud with optional color/normals -> (points, colors, normals);
    an empty cloud gives (0, 3) arrays (the JAX package's reader fails on
    the colour range of an empty array)."""
    props, _ = read_ply(path)
    pts = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float32)
    if "red" in props:
        colors = np.stack([props["red"], props["green"], props["blue"]],
                          axis=1).astype(np.float32)
        if colors.size and colors.max() > 1.5:
            colors = colors / 255.0
    else:
        colors = np.zeros_like(pts)
    if "nx" in props:
        normals = np.stack([props["nx"], props["ny"], props["nz"]],
                           axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def write_points_ply(path: str, points: np.ndarray,
                     colors: np.ndarray | None = None,
                     normals: np.ndarray | None = None) -> None:
    props = {"x": points[:, 0].astype(np.float32),
             "y": points[:, 1].astype(np.float32),
             "z": points[:, 2].astype(np.float32)}
    if normals is not None:
        props.update(nx=normals[:, 0].astype(np.float32),
                     ny=normals[:, 1].astype(np.float32),
                     nz=normals[:, 2].astype(np.float32))
    if colors is not None:
        c = colors
        if c.size and c.max() <= 1.5:
            c = c * 255.0
        c = c.astype(np.uint8)
        props.update(red=c[:, 0], green=c[:, 1], blue=c[:, 2])
    write_ply(path, props)
