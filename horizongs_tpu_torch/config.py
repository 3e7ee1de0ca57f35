"""Config system: YAML with three namespaces, `model_params`,
`optim_params` and `pipeline_params`, as Horizon-GS's `parse_cfg`.

A copy of `horizongs_tpu/config.py` (this package imports nothing of the
JAX package), with the same defaults, which follow
`config/ours/matrix_city/block_small/coarse.yaml`; the defaults layer lets
tests and programmatic use skip full YAML files. The model's
`model_config` dict becomes `models/config.py::ModelConfig`.
"""
from __future__ import annotations

from types import SimpleNamespace

DEFAULT_OPTIM = dict(
    iterations=60000,
    position_lr_init=0.0, position_lr_final=0.0,
    position_lr_delay_mult=0.01, position_lr_max_steps=60000,
    offset_lr_init=0.001, offset_lr_final=0.00001,
    offset_lr_delay_mult=0.01, offset_lr_max_steps=60000,
    feature_lr=0.0075, scaling_lr=0.007, rotation_lr=0.002,
    mlp_opacity_lr_init=0.002, mlp_opacity_lr_final=0.00002,
    mlp_opacity_lr_delay_mult=0.01, mlp_opacity_lr_max_steps=60000,
    mlp_cov_lr_init=0.004, mlp_cov_lr_final=0.004,
    mlp_cov_lr_delay_mult=0.01, mlp_cov_lr_max_steps=60000,
    mlp_color_lr_init=0.008, mlp_color_lr_final=0.00005,
    mlp_color_lr_delay_mult=0.01, mlp_color_lr_max_steps=60000,
    appearance_lr_init=0.0, appearance_lr_final=0.0,
    appearance_lr_delay_mult=0.01, appearance_lr_max_steps=60000,
    lambda_dssim=0.2, lambda_dreg=0.01,
    lambda_sky_opa=0.05, lambda_opacity_entropy=0.05,
    lambda_normal=0.0, normal_start_iter=7000,
    lambda_dist=0.0, dist_start_iter=3000,
    start_stat=500, update_from=1500, update_interval=100,
    update_until=30000, overlap=False, densification=True,
    growing_type="mean", pruning_type="mean", min_opacity=0.005,
    success_threshold=0.8, densify_grad_threshold=0.0002,
    update_ratio=0.2, extra_ratio=0.25, extra_up=0.05,
    start_depth=500, depth_l1_weight_init=1.0, depth_l1_weight_final=0.01,
)

DEFAULT_PIPELINE = dict(
    camera_balance=True, camera_proportion="2-1",
    aerial_densify=True, street_densify=False,
    weed_ratio=0.0, add_prefilter=True, vis_step=5000,
    no_prefilter_step=0,
)

DEFAULT_MODEL = dict(
    model_config={"name": "GaussianLoDModel", "kwargs": {}},
    pretrained_checkpoint="", global_appearance="",
    dataset_name="", scene_name="", images="images", resolution=-1,
    white_background=False, random_background=False,
    resolution_scales=[1.0], data_device="cpu", eval=True, ratio=1,
    data_format="colmap", add_mask=False, add_depth=False,
    add_aerial=True, add_street=True, scale=1.0, center=[0, 0, 0],
    source_path="", model_path="", llffhold=32,
)


def make_namespace(defaults: dict, overrides: dict | None = None) -> SimpleNamespace:
    d = dict(defaults)
    d.update(overrides or {})
    return SimpleNamespace(**d)


def make_optim(**overrides) -> SimpleNamespace:
    return make_namespace(DEFAULT_OPTIM, overrides)


def make_pipeline(**overrides) -> SimpleNamespace:
    return make_namespace(DEFAULT_PIPELINE, overrides)


def make_model_params(**overrides) -> SimpleNamespace:
    return make_namespace(DEFAULT_MODEL, overrides)


def parse_cfg(cfg: dict):
    """YAML dict -> (lp, op, pp) namespaces with defaults filled in."""
    lp = make_namespace(DEFAULT_MODEL, cfg.get("model_params", {}))
    op = make_namespace(DEFAULT_OPTIM, cfg.get("optim_params", {}))
    pp = make_namespace(DEFAULT_PIPELINE, cfg.get("pipeline_params", {}))
    return lp, op, pp


def load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)
