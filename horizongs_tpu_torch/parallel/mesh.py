"""The training mesh on `torch.distributed`: ranks laid out data x model.

The JAX package's `parallel/mesh.py` builds a `jax.sharding.Mesh` over the
devices of one program. Here every rank is a process of its own, so the
mesh is this rank's view of the layout:

  "data"  — cameras: each data index renders its own view, and gradients
            are mean-reduced over this axis;
  "model" — the anchor table's rows and the image's tile bands: each model
            index decodes its rows and composites its band
            (`parallel/step.py`).

Rank r sits at (d, m) = divmod(r, model), as `np.reshape(devices, (data,
model))` lays devices out. Each axis is one process group: the ranks of
this rank's data column and of its model row. A 1x1 mesh in a process that
did not initialise `torch.distributed` has no groups, and every collective
on it is the identity (`parallel/collectives.py`).

The backend follows the topology, chosen before anything runs and logged:
NCCL when every rank on a host has a card of its own, gloo when ranks share
a card or run on the CPU. NCCL refuses two ranks on one card.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from horizongs_tpu_torch.device import DeviceLike


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int) -> tuple:
    """(backend, reason): NCCL when each of this host's ranks has a card
    of its own, gloo when they share one or run on the CPU."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    if local_world_size <= n_cards:
        return "nccl", (f"{local_world_size} rank(s) on this host, "
                        f"{n_cards} card(s): one card each")
    return "gloo", (f"{local_world_size} ranks share {n_cards} card(s): NCCL "
                    f"refuses two ranks on one card")


def rank_device(device: DeviceLike = None,
                local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:(LOCAL_RANK % cards)`, or `device` when
    the caller names one (the CPU in the tests)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "train on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: DeviceLike = None,
                     local_world_size: Optional[int] = None,
                     logger=None) -> str:
    """`init_process_group` with the backend of `choose_backend` for this
    rank's device. `init_method` is a `tcp://` or `file://` address;
    `local_world_size` defaults to the world size (one host). Returns the
    backend."""
    dev = rank_device(device, rank)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, why = choose_backend(
        dev.type, local_world_size or world_size, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    (logger.info if logger else print)(
        f"torch.distributed: rank {rank}/{world_size} on {dev}, backend "
        f"{backend} ({why})")
    return backend


def maybe_init_distributed(device: DeviceLike = None, logger=None) -> int:
    """Multi-process bring-up from the `torch.distributed.run` environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), in place of the JAX package's coordinator variables.
    Returns this rank, 0 when the process was not launched distributed.
    Safe to call twice: a second call logs and returns the rank."""
    log = logger.info if logger else print
    if dist.is_initialized():
        log(f"torch.distributed already initialised: rank "
            f"{dist.get_rank()}/{dist.get_world_size()}")
        return dist.get_rank()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, local_rank)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, why = choose_backend(dev.type, local_world, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    log(f"torch.distributed: rank {rank}/{world} on {dev}, backend "
        f"{backend} ({why})")
    return rank


class Mesh:
    """This rank's place in a data x model layout and one process group
    per axis (None without `torch.distributed`)."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, groups: dict,
                 backend: Optional[str]):
        self.shape = {"data": data, "model": model}
        self.layout = np.arange(data * model).reshape(data, model)
        self.rank = rank
        self.d, self.m = divmod(rank, model)
        self.device = device
        self.groups = groups
        self.backend = backend

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def group(self, axis: str):
        """The process group of "data", "model" or "world"."""
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank} at ({self.d}, "
                f"{self.m}), {self.device}, {self.backend})")


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the initialised world (`data` defaults
    to world / model), or a 1x1 mesh without groups in a process that did
    not initialise `torch.distributed`. Every rank must call it, in the
    same order as any other group creation: each axis group is made with
    `dist.new_group` by all ranks."""
    if not dist.is_initialized():
        data = 1 if data is None else data
        if data * model != 1:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"ranks; torch.distributed is not initialised")
        return Mesh(1, 1, 0, rank_device(device),
                    {"data": None, "model": None, "world": None}, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not match "
                         f"{world} ranks")
    layout = np.arange(world).reshape(data, model)
    groups = {"world": dist.group.WORLD}
    for row in layout:                       # "model": one row per data index
        g = dist.new_group([int(r) for r in row])
        if rank in row:
            groups["model"] = g
    for col in layout.T:                     # "data": one column per model
        g = dist.new_group([int(r) for r in col])
        if rank in col:
            groups["data"] = g
    if device is None:
        device = rank_device(None, int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(data, model, rank, torch.device(device), groups,
                dist.get_backend())


def parse_mesh_spec(spec: Optional[str],
                    device: DeviceLike = None) -> Optional[Mesh]:
    """CLI mesh spec -> Mesh, on the world size: None or "" -> no mesh (the
    single-device step); "auto" -> every rank as data x 1 when there are at
    most 2, else (n/2) x 2 (None for one rank); "DxM" -> data x model."""
    if not spec:
        return None
    n = dist.get_world_size() if dist.is_initialized() else 1
    if spec == "auto":
        if n == 1:
            return None
        model = 2 if n % 2 == 0 and n > 2 else 1
        return make_mesh(data=n // model, model=model, device=device)
    data_s, model_s = spec.lower().split("x")
    data, model = int(data_s), int(model_s)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"only {n} launched")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves ranks of the {n} "
                         f"launched without a place")
    return make_mesh(data=data, model=model, device=device)
