"""Model checkpoint I/O: anchor PLYs, MLP weights and full training
checkpoints, in the JAX package's file layouts, so that either package
reads the other's files.

  * The anchor PLY is the reference's schema (`save_ply`/`load_ply`,
    `base_model.py:312-380`, `lod_model.py:374-464`), written by a copy of
    the JAX package's PLY codec: offsets channel-major
    (f_offset_i = dim*k + offset), the LOD model's level/extra_level
    columns and its obj_info scalars standard_dist / aerial_levels /
    street_levels.
  * `mlps.npz` holds each decoder as opacity/l1/w, .../b, .../l2/w,
    .../l2/b (and the appearance table). The port's decoders store their
    weights (in, out), as the JAX package's dense layers do, so nothing is
    transposed.
  * The explicit PLY (the SH bake, `models/explicit.py`) is the
    reference's 3DGS schema (`base_model.py:566-697`): f_dc / f_rest
    channel-major, the raw opacity, linear scales, and the LOD model's
    level / extra_level columns and obj_info scalars.
  * A training checkpoint is one npz of the whole training state under the
    JAX package's flattened `TrainState` keys (params/..., rotation, level,
    extra_level, n, opt/mu/..., opt/nu/..., opt/t, stats/...) plus
    `__iteration__`; no pickle.

  * A sharded checkpoint (`save_sharded_checkpoint`) is a directory,
    `chkpnt{it}_sharded/`, in the port's own format: each "model" index of
    the mesh writes its rows of every per-anchor leaf (`rows_{m}.npz`, no
    gather), rank 0 the replicated leaves (`replicated.npz`) and last a
    `manifest.json` (mesh shape, capacity, iteration, the keys). The keys
    are the npz checkpoint's, so a sharded checkpoint restores at any mesh
    shape. The JAX package's orbax directories are not read.
"""
from __future__ import annotations

import json
import os
import re
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from horizongs_tpu_torch.convert import (
    anchor_state_from_numpy,
    mlps_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from horizongs_tpu_torch.device import DeviceLike
from horizongs_tpu_torch.io.plyio import read_ply, write_ply
from horizongs_tpu_torch.models.anchors import AnchorState, round_capacity
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders
from horizongs_tpu_torch.train.densify import TABLES
from horizongs_tpu_torch.train.step import DensifyStats, TrainState

# the JAX package's `TrainableParams` fields, in its order
_PARAMS = ("anchor", "offset", "feat", "scaling_log", "mlp_opacity",
           "mlp_cov", "mlp_color", "appearance")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# anchor PLY
# ---------------------------------------------------------------------------

def save_anchor_ply(path: str, cfg: ModelConfig, state: AnchorState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = int(state.n)
    k = state.n_offsets
    anchor = _host(state.anchor[:n])
    offset = _host(state.offset[:n])                        # (n, k, 3)
    offset_t = offset.transpose(0, 2, 1).reshape(n, 3 * k)  # channel-major
    feat = _host(state.feat[:n])
    scaling = _host(state.scaling_log[:n])
    rot = _host(state.rotation[:n])

    props = {"x": anchor[:, 0], "y": anchor[:, 1], "z": anchor[:, 2]}
    obj_info = [f"num_anchor {n:.6f}"]
    if cfg.is_lod:
        props["level"] = _host(state.level[:n]).astype(np.float32)
        props["extra_level"] = _host(state.extra_level[:n])
        obj_info = [f"standard_dist {cfg.standard_dist:.6f}",
                    f"aerial_levels {cfg.aerial_levels:.6f}",
                    f"street_levels {cfg.street_levels:.6f}"]
    for i in range(3 * k):
        props[f"f_offset_{i}"] = offset_t[:, i]
    for i in range(feat.shape[1]):
        props[f"f_anchor_feat_{i}"] = feat[:, i]
    for i in range(6):
        props[f"scale_{i}"] = scaling[:, i]
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    write_ply(path, props, obj_info)


def _sorted_cols(props: dict, prefix: str) -> np.ndarray:
    names = sorted((k for k in props if k.startswith(prefix)),
                   key=lambda s: int(s.split("_")[-1]))
    return np.stack([props[k] for k in names], axis=1).astype(np.float32)


def load_anchor_ply(path: str, cfg: ModelConfig,
                    capacity: Optional[int] = None,
                    device: DeviceLike = None) -> Tuple[AnchorState, dict]:
    """Returns (state, obj_info dict), the table padded to `capacity` rows
    (default `round_capacity(n)`). obj_info carries the LOD scalars:
    callers fold them back into the config."""
    props, info_lines = read_ply(path)
    info = {}
    for line in info_lines:
        key, val = line.split()[0], line.split()[1]
        info[key] = float(val)

    anchor = np.stack([props["x"], props["y"], props["z"]],
                      axis=1).astype(np.float32)
    n = anchor.shape[0]
    offsets = _sorted_cols(props, "f_offset_")
    k = offsets.shape[1] // 3
    offsets = offsets.reshape(n, 3, k).transpose(0, 2, 1)  # (n, k, 3)
    level = props.get("level")
    level = (np.zeros(n, np.int32) if level is None
             else np.asarray(level).astype(np.int32))
    extra = props.get("extra_level")
    extra = (np.zeros(n, np.float32) if extra is None
             else np.asarray(extra).astype(np.float32))
    C = capacity or round_capacity(n)

    def pad(a):
        out = np.zeros((C,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return out

    rot = pad(_sorted_cols(props, "rot_"))
    rot[n:, 0] = 1.0
    state = anchor_state_from_numpy(
        {"anchor": pad(anchor), "offset": pad(offsets),
         "feat": pad(_sorted_cols(props, "f_anchor_feat_")),
         "scaling_log": pad(_sorted_cols(props, "scale_")), "rotation": rot,
         "level": pad(level), "extra_level": pad(extra), "n": n},
        device=device)
    return state, info


# ---------------------------------------------------------------------------
# explicit PLY
# ---------------------------------------------------------------------------

def explicit_ply_props(cfg: ModelConfig, arrays: dict) -> Tuple[dict, list]:
    """Explicit-gaussian arrays (`models.explicit.bake_explicit`) ->
    (ordered PLY props, obj_info) in the reference's schema."""
    xyz = arrays["xyz"]
    n = xyz.shape[0]
    feats = arrays["features"]                     # (n, K, 3)
    f_dc = feats[:, 0:1, :].transpose(0, 2, 1).reshape(n, 3)
    f_rest = feats[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    obj_info = []
    if cfg.is_lod:
        props["level"] = arrays["level"].astype(np.float32)
        props["extra_level"] = arrays["extra_level"]
        obj_info = [f"standard_dist {cfg.standard_dist:.6f}",
                    f"aerial_levels {cfg.aerial_levels:.6f}",
                    f"street_levels {cfg.street_levels:.6f}"]
    for i in range(3):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = arrays["opacity"]
    for i in range(3):
        props[f"scale_{i}"] = arrays["scaling"][:, i]
    for i in range(4):
        props[f"rot_{i}"] = arrays["rotation"][:, i]
    return props, obj_info


def save_explicit_ply(path: str, cfg: ModelConfig, arrays: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    props, obj_info = explicit_ply_props(cfg, arrays)
    write_ply(path, props, obj_info)


def load_explicit_ply(path: str) -> Tuple[dict, dict]:
    """Returns (arrays, obj_info dict); level and extra_level are zeros
    when the file has none (a flat model's)."""
    props, info_lines = read_ply(path)
    info = {line.split()[0]: float(line.split()[1]) for line in info_lines}
    xyz = np.stack([props["x"], props["y"], props["z"]],
                   axis=1).astype(np.float32)
    n = xyz.shape[0]
    f_dc = np.stack([props["f_dc_0"], props["f_dc_1"], props["f_dc_2"]],
                    axis=1).astype(np.float32)[:, None, :]    # (n, 1, 3)
    rest = _sorted_cols(props, "f_rest_")
    # stored channel-major: (n, 3, K_rest) -> (n, K_rest, 3)
    rest = rest.reshape(n, 3, rest.shape[1] // 3).transpose(0, 2, 1)
    arrays = {
        "xyz": xyz,
        "features": np.concatenate([f_dc, rest], axis=1).astype(np.float32),
        "opacity": np.asarray(props["opacity"]).astype(np.float32),
        "scaling": _sorted_cols(props, "scale_"),
        "rotation": _sorted_cols(props, "rot_"),
    }
    if "level" in props:
        arrays["level"] = np.asarray(props["level"]).astype(np.int32)
        arrays["extra_level"] = np.asarray(
            props["extra_level"]).astype(np.float32)
    else:
        arrays["level"] = np.zeros(n, np.int32)
        arrays["extra_level"] = np.zeros(n, np.float32)
    return arrays, info


# ---------------------------------------------------------------------------
# MLP weights and full checkpoints: flat npz under the JAX package's keys
# ---------------------------------------------------------------------------

def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": array}; None leaves are left out (the
    JAX package's `_flatten` of its pytrees)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def save_mlp_checkpoints(dirpath: str, mlps: MlpDecoders) -> None:
    os.makedirs(dirpath, exist_ok=True)
    tree = {}
    for name in ("opacity", "cov", "color"):
        m = getattr(mlps, name)
        tree[name] = {"l1": {"w": _host(m.w1), "b": _host(m.b1)},
                      "l2": {"w": _host(m.w2), "b": _host(m.b2)}}
    if mlps.appearance is not None:
        tree["appearance"] = _host(mlps.appearance)
    np.savez(os.path.join(dirpath, "mlps.npz"), **_flatten(tree))


def load_mlp_checkpoints(dirpath: str,
                         device: DeviceLike = None) -> MlpDecoders:
    z = np.load(os.path.join(dirpath, "mlps.npz"))

    def layer(name):
        return {l: {q: z[f"{name}/{l}/{q}"] for q in ("w", "b")}
                for l in ("l1", "l2")}
    appearance = z["appearance"] if "appearance" in z.files else None
    return mlps_from_numpy(layer("opacity"), layer("cov"), layer("color"),
                           appearance, device=device)


def _flat_state(state: TrainState) -> dict:
    """The state's leaves under the npz checkpoint's flattened keys."""
    t = train_state_to_numpy(state)
    return _flatten({"params": t["params"], "rotation": t["rotation"],
                     "level": t["level"], "extra_level": t["extra_level"],
                     "n": np.asarray(t["n"], np.int32),
                     "opt": {"mu": t["mu"], "nu": t["nu"],
                             "t": np.asarray(t["t"], np.int32)},
                     "stats": t["stats"]})


def save_train_checkpoint(path: str, state: TrainState,
                          iteration: int) -> None:
    """The whole training state (params, moments, statistics, counters)
    in one npz under the JAX package's keys, plus `__iteration__`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flat_state(state)
    flat["__iteration__"] = np.asarray(iteration)
    np.savez(path, **flat)


def _unflatten(z, prefix: str):
    """The npz entries under `prefix` -> nested dicts."""
    out = {}
    for key in z.files:
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out


def _params_ns(tree: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: tree.get(k) for k in _PARAMS})


def load_train_checkpoint(path: str, device: DeviceLike = None
                          ) -> Tuple[TrainState, int]:
    """A training checkpoint of either package -> (state, iteration), at
    the capacity it was saved with."""
    z = np.load(path)
    return _state_from_flat(z, device), int(z["__iteration__"])


def _state_from_flat(z, device: DeviceLike) -> TrainState:
    """A mapping of the npz checkpoint's keys (with `.files`) -> state."""
    ts = SimpleNamespace(
        params=_params_ns(_unflatten(z, "params/")),
        rotation=z["rotation"], level=z["level"],
        extra_level=z["extra_level"], n=z["n"],
        opt=SimpleNamespace(mu=_params_ns(_unflatten(z, "opt/mu/")),
                            nu=_params_ns(_unflatten(z, "opt/nu/")),
                            t=z["opt/t"]),
        stats=SimpleNamespace(**{f: z[f"stats/{f}"]
                                 for f in DensifyStats._fields}))
    return train_state_from_numpy(ts, device=device)


# ---------------------------------------------------------------------------
# sharded checkpoints: one directory, each "model" index writes its rows
# ---------------------------------------------------------------------------

_ROW_LEAVES = ("rotation", "level", "extra_level")
_MANIFEST = "manifest.json"


def _is_row_key(key: str) -> bool:
    """Whether a flattened key is a per-anchor (or per-offset) leaf."""
    return (key in _ROW_LEAVES or key.startswith("stats/")
            or key.split("/")[-1] in TABLES)


class _Flat(dict):
    """A dict with the `.files` of an npz."""

    @property
    def files(self):
        return list(self)


def save_sharded_checkpoint(path: str, state: TrainState, iteration: int,
                            mesh) -> None:
    """The state of a mesh (`parallel/step.shard_state`), each rank at
    data index 0 writing its own rows (`rows_{m}.npz`) and rank 0 the
    replicated leaves and the manifest; every rank of the mesh must call
    it. `path` is a directory."""
    import torch.distributed as dist
    os.makedirs(path, exist_ok=True)
    flat = _flat_state(state)
    rows = {k: v for k, v in flat.items() if _is_row_key(k)}
    n_model = mesh.shape["model"]
    names = [f"rows_{m:04d}.npz" for m in range(n_model)]
    if mesh.d == 0:
        np.savez(os.path.join(path, names[mesh.m]), **rows)
    if mesh.is_main:
        np.savez(os.path.join(path, "replicated.npz"),
                 **{k: v for k, v in flat.items() if k not in rows})
    if dist.is_initialized():
        dist.barrier(group=mesh.group("world"))
    if mesh.is_main:
        manifest = {
            "format": "horizongs_tpu_torch sharded checkpoint 1",
            "mesh": [mesh.shape["data"], n_model],
            "capacity": int(state.params.anchor.shape[0]) * n_model,
            "iteration": int(iteration), "n": int(state.n),
            "row_files": names, "row_keys": sorted(rows),
            "replicated_keys": sorted(k for k in flat if k not in rows)}
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    if dist.is_initialized():
        dist.barrier(group=mesh.group("world"))


def sharded_checkpoint_capacity(path: str) -> int:
    """The anchor capacity a sharded checkpoint holds, from its manifest
    (a resume decides from it whether the state must be re-padded)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        return int(json.load(f)["capacity"])


def load_sharded_checkpoint(path: str, device: DeviceLike = None,
                            mesh=None) -> Tuple[TrainState, int]:
    """A sharded checkpoint -> (state, iteration) at the capacity it was
    saved with, whatever mesh saved it: the whole state, or with `mesh`
    this rank's rows of it (`parallel/step.shard_state`'s slice; the
    capacity must then divide the mesh's "model" axis — re-pad the whole
    state otherwise, as `Trainer.restore` does)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        man = json.load(f)
    flat = _Flat(np.load(os.path.join(path, "replicated.npz")))
    shards = [np.load(os.path.join(path, n)) for n in man["row_files"]]
    C = int(man["capacity"])
    lo, hi = 0, C
    if mesh is not None:
        n_model = mesh.shape["model"]
        if C % n_model:
            raise ValueError(f"checkpoint capacity {C} does not divide "
                             f"model={n_model}: load it whole and pad it")
        c = C // n_model
        lo, hi = mesh.m * c, (mesh.m + 1) * c
    for key in man["row_keys"]:
        full = np.concatenate([z[key] for z in shards])
        per = full.shape[0] // C
        flat[key] = full[lo * per:hi * per]
    return _state_from_flat(flat, device), int(man["iteration"])


def search_max_iteration(point_cloud_dir: str) -> int:
    """`searchForMaxIteration` (`utils/system_utils.py:26-28`)."""
    best = -1
    if not os.path.isdir(point_cloud_dir):
        return best
    for name in os.listdir(point_cloud_dir):
        m = re.match(r"iteration_(\d+)", name)
        if m:
            best = max(best, int(m.group(1)))
    return best
