"""Shared CLI plumbing: config loading, logging, output dirs."""
from __future__ import annotations

import logging
import os

from horizongs_tpu_torch.config import load_yaml, parse_cfg
from horizongs_tpu_torch.models.config import ModelConfig


def get_logger(name: str, model_path: str | None = None):
    """Console logger, plus `<model_path>/outputs.log` when given
    (`train.py:671-687`)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if model_path:
        os.makedirs(model_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(model_path, "outputs.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def load_config(path: str, model_path_override: str | None = None):
    """YAML -> (lp, op, pp, cfg). Fills model_path from the dataset and
    scene names when absent (the reference's outputs/<dataset>/<scene>)."""
    lp, op, pp = parse_cfg(load_yaml(path))
    cfg = ModelConfig.from_dict(lp.model_config)
    if model_path_override:
        lp.model_path = model_path_override
    elif not getattr(lp, "model_path", ""):
        lp.model_path = os.path.join("outputs", str(lp.dataset_name),
                                     str(lp.scene_name))
    return lp, op, pp, cfg
