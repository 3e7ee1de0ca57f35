"""The port's LPIPS (`train/lpips.py`) against the JAX package's
`train/lpips_jax.py` on the CPU, with `init_random_weights(0)` (the
pretrained VGG weights cannot be downloaded): `lpips_distance` on two
image pairs at 64x64 (rtol 1e-4), the [0, 1] scorer `lpips_fn`, one npz
in the JAX package's schema loaded by the port (an explicit path, then
`$HGS_LPIPS_WEIGHTS`), and `lpips_fn_or_none` with no weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizongs_tpu.train import lpips_jax
from horizongs_tpu_torch.device import disable_tf32
from horizongs_tpu_torch.train import lpips as tlpips
from horizongs_tpu_torch.train.evaluate import lpips_fn_or_none

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    # the second image a noisy copy of the first, so the scores differ
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    b[1] = rng.uniform(0, 1, (64, 64, 3))
    return a, b


def test_random_weights_match_jax():
    j, t = lpips_jax.init_random_weights(0), tlpips.init_random_weights(0)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_lpips_distance_matches_jax(pairs):
    disable_tf32()
    a, b = pairs
    params = tlpips.init_random_weights(0)
    want = np.asarray(lpips_jax.lpips_distance(
        params, jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    got = tlpips.lpips_distance(params, torch.from_numpy(a * 2 - 1),
                                torch.from_numpy(b * 2 - 1)).numpy()
    assert want.shape == got.shape == (2,)
    assert want[1] > want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the [0, 1] scorers on one pair
    jfn = lpips_jax.lpips_fn(params=params)
    tfn = tlpips.lpips_fn(params=params, device="cpu")
    np.testing.assert_allclose(tfn(a[0], b[0]), float(jfn(a[0], b[0])),
                               rtol=1e-4)
    assert tfn(a[0], a[0]) == 0.0


def test_npz_of_the_jax_schema_loads(tmp_path, monkeypatch, pairs):
    """An npz with the JAX package's keys and HWIO kernels: the port
    reads it from a path and from $HGS_LPIPS_WEIGHTS and scores as the
    JAX package does with it."""
    params = lpips_jax.init_random_weights(1)
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **params)
    loaded = tlpips.load_weights(path)
    assert loaded["conv0_w"].shape == (3, 3, 3, 64)
    assert tlpips.load_weights(str(tmp_path / "missing.npz")) is None
    monkeypatch.setenv("HGS_LPIPS_WEIGHTS", path)
    a, b = pairs
    fn = lpips_fn_or_none("cpu")
    want = float(lpips_jax.lpips_fn()(a[1], b[1]))
    np.testing.assert_allclose(fn(a[1], b[1]), want, rtol=1e-4)


def test_no_weights_gives_none(tmp_path, monkeypatch):
    monkeypatch.setenv("HGS_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert tlpips.lpips_fn() is None
    assert lpips_fn_or_none() is None
