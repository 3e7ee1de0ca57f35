# Frozen copy of horizongs_tpu_torch/train/schedules.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""Learning-rate schedules (Plenoxels-style log-lerp with delay warmup).

The JAX package's `train/schedules.py` (`get_expon_lr_func` of Horizon-GS)
as plain Python: the step runs eagerly, so each LR is a Python float
computed on the host once per step.
"""
from __future__ import annotations

import math


def expon_lr(step: float, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Continuous LR: lr_init at step 0, lr_final at max_steps, log-lerped.
    Returns 0 when both endpoints are 0 (parameter disabled)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    # guard log(0): only one endpoint may be 0
    li = max(lr_init, 1e-32)
    lf = max(lr_final, 1e-32)
    return delay_rate * math.exp(math.log(li) * (1 - t) + math.log(lf) * t)


def group_lrs(opt, step: float, spatial_lr_scale: float) -> dict:
    """All per-group LRs for one step: anchor/offset scaled by the spatial
    extent, feature/scaling constant, MLPs and appearance scheduled."""
    return {
        "anchor": expon_lr(step,
                           opt.position_lr_init * spatial_lr_scale,
                           opt.position_lr_final * spatial_lr_scale,
                           lr_delay_mult=opt.position_lr_delay_mult,
                           max_steps=opt.position_lr_max_steps),
        "offset": expon_lr(step,
                           opt.offset_lr_init * spatial_lr_scale,
                           opt.offset_lr_final * spatial_lr_scale,
                           lr_delay_mult=opt.offset_lr_delay_mult,
                           max_steps=opt.offset_lr_max_steps),
        "feat": float(opt.feature_lr),
        "scaling_log": float(opt.scaling_lr),
        "mlp_opacity": expon_lr(step, opt.mlp_opacity_lr_init,
                                opt.mlp_opacity_lr_final,
                                lr_delay_mult=opt.mlp_opacity_lr_delay_mult,
                                max_steps=opt.mlp_opacity_lr_max_steps),
        "mlp_cov": expon_lr(step, opt.mlp_cov_lr_init, opt.mlp_cov_lr_final,
                            lr_delay_mult=opt.mlp_cov_lr_delay_mult,
                            max_steps=opt.mlp_cov_lr_max_steps),
        "mlp_color": expon_lr(step, opt.mlp_color_lr_init,
                              opt.mlp_color_lr_final,
                              lr_delay_mult=opt.mlp_color_lr_delay_mult,
                              max_steps=opt.mlp_color_lr_max_steps),
        "appearance": expon_lr(
            step, getattr(opt, "appearance_lr_init", 0.0),
            getattr(opt, "appearance_lr_final", 0.0),
            lr_delay_mult=getattr(opt, "appearance_lr_delay_mult", 0.01),
            max_steps=getattr(opt, "appearance_lr_max_steps", 30000)),
    }
