"""Port parity, losses: `train/losses.py` against the JAX package's, values
and `jax.grad` with respect to the images, atol 1e-6 / rtol 1e-5.

The JAX package blurs the SSIM moments with a bf16x3 split product
(`_dot3`), a TPU precision workaround the port does not carry (it blurs in
float32). The split truncates its operands with a bitcast, which has no
derivative, so the JAX gradient of SSIM is taken against bf16-rounded blur
weights and is good to about 2^-8 only. The SSIM gradients are therefore
held against the JAX package's own functions with that blur swapped for a
float32 product (`f32_blur`), and one test shows the size of the
difference the swap removes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.config import make_optim as j_make_optim
from horizongs_tpu.train import losses as jl
from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.train import losses as tl

# small shapes: one torch thread per test worker process, so parallel
# workers do not oversubscribe the cores
torch.set_num_threads(1)

H, W = 40, 52
TOL = dict(atol=1e-6, rtol=1e-5)


def _blur5_f32(img1, img2):
    """The JAX package's `_blur5` with float32 products in place of the
    bf16x3 split: the same banded blur matrices, the same outputs."""
    X = jnp.concatenate([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        axis=-1)                            # (H, W, 5C)
    Bw, Bh = jl._blur_band(img1.shape[1]), jl._blur_band(img1.shape[0])
    Z = jnp.einsum("hwc,wv,hu->uvc", X, Bw, Bh,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.split(Z, 5, axis=-1)


@pytest.fixture
def f32_blur(monkeypatch):
    monkeypatch.setattr(jl, "_blur5", _blur5_f32)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def _grad_t(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _grad_j(fn, *xs):
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(xs))))(
        *(jnp.asarray(x) for x in xs))
    return np.asarray(val), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["l1_loss", "psnr", "ssim"])
def test_scalar_losses_match(name, f32_blur):
    a, b = _images()
    vt, gt = _grad_t(getattr(tl, name), a, b)
    vj, gj = _grad_j(getattr(jl, name), a, b)
    np.testing.assert_allclose(vt, vj, **TOL)
    for x, y in zip(gt, gj):
        np.testing.assert_allclose(x, y, **TOL)


def test_ssim_map_matches(f32_blur):
    a, b = _images(1)
    sm_t = tl.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(sm_t, np.asarray(jl.ssim_map(a, b)), **TOL)
    # the blur itself: zero-padded borders, the JAX band's weights
    mu_t = tl._blur5(torch.from_numpy(a), torch.from_numpy(b))[0].numpy()
    np.testing.assert_allclose(mu_t, np.asarray(_blur5_f32(a, b)[0]), **TOL)


def test_ssim_value_matches_bf16x3_blur():
    """Against the JAX package as it is, the SSIM value agrees (the split
    product is float32-accurate), its gradient only to bf16's 2^-8: that
    difference is the reason for `f32_blur` above."""
    a, b = _images(2)
    vt, gt = _grad_t(tl.ssim, a, b)
    vj, gj = _grad_j(jl.ssim, a, b)
    np.testing.assert_allclose(vt, vj, **TOL)
    rel = np.abs(gt[0] - gj[0]).max() / np.abs(gj[0]).max()
    assert 1e-5 < rel < 2.0 ** -7, rel


def _pkg(seed=3, n=64):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 1, (H, W, 1)).astype(np.float32)
    alpha[:5] = 0.0                                  # empty rows
    depth = rng.uniform(0.5, 4.0, (H, W, 1)).astype(np.float32)
    depth[:5] = 0.0                                  # no depth there
    return {"render": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
            "render_alphas": alpha, "render_depth": depth,
            "scaling": rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32),
            "selection_mask": rng.uniform(size=n) > 0.3}


@pytest.mark.parametrize("iteration", [100.0, 900.0],
                         ids=["depth_gated_off", "depth_on"])
def test_assemble_loss_matches(iteration, f32_blur):
    """Every 3DGS term on (dssim, dreg over the selected gaussians, sky
    opacity, opacity entropy) and the inverse-depth L1, gated at
    start_depth = 500; values and gradients w.r.t. the image, alphas,
    depth and scaling."""
    kw = dict(lambda_dssim=0.2, lambda_dreg=0.01, lambda_sky_opa=0.05,
              lambda_opacity_entropy=0.05, start_depth=500)
    opt_j, opt_t = j_make_optim(**kw), make_optim(**kw)
    pkg = _pkg()
    rng = np.random.default_rng(4)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    amask = (rng.uniform(size=(H, W, 1)) > 0.2).astype(np.float32)
    inv = rng.uniform(0.2, 1.5, (H, W, 1)).astype(np.float32)
    dmask = (rng.uniform(size=(H, W, 1)) > 0.1).astype(np.float32)
    keys = ("render", "render_alphas", "render_depth", "scaling")

    def j_loss(*xs):
        p = dict(pkg, **dict(zip(keys, xs)))
        p["selection_mask"] = jnp.asarray(pkg["selection_mask"], jnp.float32)
        return jl.assemble_loss(opt_j, p, gt, amask, inv, dmask,
                                jnp.float32(iteration), jnp.float32(0.3),
                                "RGB+ED")

    def t_loss(*xs):
        p = dict(pkg, **dict(zip(keys, xs)))
        p["selection_mask"] = torch.from_numpy(pkg["selection_mask"])
        return tl.assemble_loss(opt_t, p, torch.from_numpy(gt),
                                torch.from_numpy(amask),
                                torch.from_numpy(inv),
                                torch.from_numpy(dmask), iteration, 0.3,
                                "RGB+ED")

    (vj, aux_j), gj = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *(jnp.asarray(pkg[k]) for k in keys))
    ts = [torch.from_numpy(pkg[k]).requires_grad_(True) for k in keys]
    vt, aux_t = t_loss(*ts)
    gt_ = torch.autograd.grad(vt, ts)
    np.testing.assert_allclose(vt.item(), float(vj), **TOL)
    for k in ("l1", "ssim", "depth_l1", "total"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   **TOL)
    assert (float(aux_t["depth_l1"].detach()) > 0) == (iteration > 500)
    for k, x, y in zip(keys, gt_, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("iteration", [5.0, 50.0],
                         ids=["surfel_terms_gated_off", "surfel_terms_on"])
def test_assemble_loss_2dgs_matches(iteration, f32_blur):
    """The 2DGS terms: the normal loss (rendered normals against the
    normals from the median depth, weighted by the detached alphas) and the
    distortion, gated at normal_start_iter = dist_start_iter = 10; values
    and gradients w.r.t. the image, alphas, normals, normals from depth and
    distortion."""
    kw = dict(lambda_dssim=0.2, lambda_normal=0.05, normal_start_iter=10,
              lambda_dist=0.01, dist_start_iter=10)
    opt_j, opt_t = j_make_optim(**kw), make_optim(**kw)
    rng = np.random.default_rng(6)
    pkg = _pkg(seed=7)
    n = rng.normal(size=(H, W, 3))
    nfd = rng.normal(size=(H, W, 3))
    pkg["render_normals"] = (0.8 * n / np.linalg.norm(n, axis=-1,
                                                      keepdims=True)
                             ).astype(np.float32)
    pkg["render_normals_from_depth"] = (
        nfd / np.linalg.norm(nfd, axis=-1, keepdims=True)).astype(np.float32)
    pkg["render_distort"] = rng.uniform(0, 0.5, (H, W, 1)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    amask = (rng.uniform(size=(H, W, 1)) > 0.2).astype(np.float32)
    keys = ("render", "render_alphas", "render_normals",
            "render_normals_from_depth", "render_distort")

    def j_loss(*xs):
        p = dict(pkg, **dict(zip(keys, xs)))
        p["selection_mask"] = jnp.asarray(pkg["selection_mask"], jnp.float32)
        return jl.assemble_loss(opt_j, p, gt, amask, None, None,
                                jnp.float32(iteration), jnp.float32(0.0),
                                "RGB+ED")

    (vj, aux_j), gj = jax.value_and_grad(j_loss, argnums=tuple(range(5)),
                                         has_aux=True)(
        *(jnp.asarray(pkg[k]) for k in keys))
    ts = [torch.from_numpy(pkg[k]).requires_grad_(True) for k in keys]
    p = {k: torch.from_numpy(v) for k, v in pkg.items()}
    p.update(zip(keys, ts))
    vt, aux_t = tl.assemble_loss(opt_t, p, torch.from_numpy(gt),
                                 torch.from_numpy(amask), None, None,
                                 iteration, 0.0, "RGB+ED")
    gt_ = torch.autograd.grad(vt, ts)
    np.testing.assert_allclose(vt.item(), float(vj), **TOL)
    for k in ("l1", "ssim", "total"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   **TOL)
    on = iteration > 10
    for k, x, y in zip(keys, gt_, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=k,
                                   **TOL)
        if k in ("render_normals", "render_normals_from_depth",
                 "render_distort"):
            assert (np.abs(x.numpy()).max() > 0) == on, k
