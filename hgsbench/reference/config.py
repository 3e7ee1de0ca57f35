# Frozen copy of horizongs_tpu_torch/models/config.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""Model configuration: the `model_config.kwargs` surface of Horizon-GS.

A copy of `horizongs_tpu/models/config.py` (this package imports nothing
of the JAX package). One dataclass covers both `GaussianModel` (flat
Scaffold-GS anchors) and `GaussianLoDModel` (octree LOD anchors); `name`
selects the behaviour.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "GaussianLoDModel"   # "GaussianModel" | "GaussianLoDModel"
    # --- shared scaffold params ---
    feat_dim: int = 32
    n_offsets: int = 10
    view_dim: int = 3                # 0 or 3 (concat unit view dir)
    appearance_dim: int = 0          # per-camera embedding width
    gs_attr: str = "3D"              # "3D" | "2D" (surfel/2DGS)
    color_attr: str = "RGB"          # "RGB" | "SH0".."SH3"
    render_mode: str = "RGB+ED"      # "RGB" | "RGB+D" | "RGB+ED"
    voxel_size: float = 0.001
    # flat-model densification grid params
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    # --- LOD params ---
    fork: int = 2
    aerial_levels: int = 3
    street_levels: int = 8
    standard_dist: float = 25.0
    dist2level: str = "floor"        # floor | round | ceil | progressive
    # misc
    padding: float = 0.0
    ape_code: int = -1               # >=0: fixed appearance code at eval

    @property
    def is_lod(self) -> bool:
        return self.name == "GaussianLoDModel"

    @property
    def max_sh_degree(self) -> Optional[int]:
        if self.color_attr == "RGB":
            return None
        return int("".join(ch for ch in self.color_attr if ch.isdigit()))

    @property
    def color_dim(self) -> int:
        deg = self.max_sh_degree
        if deg is None:
            return 3
        return 3 * (deg + 1) ** 2

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        name = d.get("name", "GaussianLoDModel")
        kwargs = dict(d.get("kwargs", {}))
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in kwargs.items() if k in fields}
        return cls(name=name, **kwargs)
