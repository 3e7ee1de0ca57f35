"""Port parity, the step options the trainer passes and the active SH
degree (the JAX trainer's arguments that the port's step and render
lacked): one step with `spatial_lr_scale`, a white background and
`frozen_appearance`, the target read from the camera
(`camera_tensors`), against the JAX step; `render` of an SH2 model at
active degrees 0 and 2 against the JAX render.

The JAX side runs its Pallas rasterizer in interpret mode and its SSIM
blur as a float32 product (`f32_blur`). Tolerances: the step's metrics
rtol 1e-5, its parameters where the gradient is large as
`test_torch_train.py`; renders atol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.config import make_optim as j_make_optim
from horizongs_tpu.core.cameras import Camera as JCamera
from horizongs_tpu.models import ModelConfig as JConfig
from horizongs_tpu.render import render as j_render
from horizongs_tpu.train import step as jstep
from horizongs_tpu.train.optim import mlps_from_params
from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.convert import (
    anchor_state_from_numpy,
    mlps_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.render import render
from horizongs_tpu_torch.train import step as tstep
from test_torch_losses import f32_blur  # noqa: F401  (fixture)
from test_torch_train import (
    LOD,
    _j_groups,
    _j_train_state,
    _leaves,
    _np,
    _targets,
)

torch.set_num_threads(1)

W = H = 48


@pytest.mark.parametrize("option", ["spatial_lr_scale", "background",
                                    "frozen_appearance"])
def test_step_option_matches_jax(option, f32_blur):
    """One step with the option against the JAX step; the port's camera
    carries its target (`camera_tensors` reads it from there)."""
    cfg_kw = dict(LOD, appearance_dim=4)
    okw = dict(iterations=2000, start_stat=0, feature_lr=0.03,
               position_lr_init=1e-3, position_lr_final=1e-5,
               appearance_lr_init=0.05, appearance_lr_final=5e-4,
               mlp_color_lr_init=0.02)
    kw_j, kw_t = {}, {}
    if option == "spatial_lr_scale":
        kw_j = kw_t = {"spatial_lr_scale": 2.5}
    elif option == "background":
        kw_j = {"background": jnp.ones(3)}
        kw_t = {"background": torch.ones(3)}
    else:
        kw_j = kw_t = {"frozen_appearance": True}
    cams, images, pts = _targets()
    ts_j = _j_train_state(JConfig(**cfg_kw), pts, capacity=256, noise=0.3)
    ts_t = train_state_from_numpy(_np(ts_j), device="cpu")
    p0 = _leaves(_np(_j_groups(ts_j.params)))   # the JAX step donates ts_j
    cam = cams[2]._replace(image=torch.from_numpy(images[2]), uid=1)
    j_cam = jstep.CameraTensors(
        viewmat=jnp.asarray(cam.viewmat.numpy()), K=jnp.asarray(cam.K.numpy()),
        cam_center=jnp.asarray(cam.cam_center.numpy()), uid=jnp.int32(1),
        image=jnp.asarray(images[2]), alpha_mask=jnp.ones((H, W, 1)),
        invdepth=jnp.zeros((H, W, 1)), depth_mask=jnp.zeros((H, W, 1)),
        has_depth=jnp.float32(0), do_stats=jnp.float32(1),
        resolution_scale=jnp.float32(1), loss_weight=jnp.float32(1))
    step_j = jstep.build_train_step(JConfig(**cfg_kw), j_make_optim(**okw),
                                    H, W, rasterizer="pallas_interpret",
                                    **kw_j)
    step_t = tstep.build_train_step(ModelConfig(**cfg_kw), make_optim(**okw),
                                    H, W, **kw_t)
    ts_j2, m_j = step_j(ts_j, j_cam, 3)
    ts_t2, m_t = step_t(ts_t, tstep.camera_tensors(cam, do_stats=True), 3)
    for k in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    got = train_state_to_numpy(ts_t2)
    g_j = {k: v / 0.1 for k, v in _leaves(_np(_j_groups(ts_j2.opt.mu)))
           .items()}
    p_j = _leaves(_np(_j_groups(ts_j2.params)))
    p_t = _leaves(got["params"])
    for k in g_j:
        big = np.abs(g_j[k]) > 1e-3 * np.abs(g_j[k]).max()
        np.testing.assert_allclose(p_t[k][big], p_j[k][big], atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    moved = np.abs(got["params"]["appearance"] - p0["appearance"]).max()
    np.testing.assert_allclose(got["params"]["appearance"],
                               _np(ts_j2.params.appearance), atol=1e-6)
    assert (moved == 0) == (option == "frozen_appearance")
    if option == "spatial_lr_scale":     # anchors moved 2.5x the base LR
        assert np.abs(p_t["anchor"] - p0["anchor"]).max() > 1e-3


def test_render_active_sh_degree_matches_jax():
    """An SH2 model rendered at active degrees 0 and 2 (and None, the
    maximum) against the JAX render."""
    cfg_kw = dict(LOD, color_attr="SH2")
    cams, _, pts = _targets(n_cams=2)
    ts_j = _j_train_state(JConfig(**cfg_kw), pts, capacity=256, noise=0.3)
    st_j = ts_j.anchor_state()
    mlps_j = mlps_from_params(ts_j.params)
    st_t = anchor_state_from_numpy(_np(st_j._asdict()), device="cpu")
    m = _np(mlps_j)
    mlps_t = mlps_from_numpy(m.opacity, m.cov, m.color, device="cpu")
    cam = cams[1]
    j_cam = JCamera(viewmat=jnp.asarray(cam.viewmat.numpy()),
                    K=jnp.asarray(cam.K.numpy()), width=W, height=H,
                    cam_center=jnp.asarray(cam.cam_center.numpy()))
    out = {}
    for deg in (0, 2, None):
        want = j_render(j_cam, JConfig(**cfg_kw), mlps_j, st_j, jnp.zeros(3),
                        active_sh_degree=deg, rasterizer="pallas_interpret")
        with torch.no_grad():
            got = render(cam, ModelConfig(**cfg_kw), mlps_t, st_t,
                         torch.zeros(3), active_sh_degree=deg)
        np.testing.assert_allclose(got["render"].numpy(),
                                   np.asarray(want["render"]), rtol=0,
                                   atol=1e-4, err_msg=str(deg))
        out[deg] = got["render"]
    assert (out[0] - out[2]).abs().max() > 1e-2
    assert torch.equal(out[2], out[None])
