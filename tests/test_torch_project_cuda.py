"""P1 on the card (`csrc/project3d.cu` through
`ops/project3d.project_fields_3dgs`) against the plain path on the same
card, and both against the plain path in float64:

  (a) 100,000 random rows with every edge: z at or behind the near plane,
      |x / z| far beyond the frustum clamp, splats whose 2D covariance
      rounds to det <= 0, unnormalised, tiny and zero quaternions,
      opacities below, at and above the alpha cutoff, boxes off the
      image, and a nonzero probe;
  (b) one decoded view of the benchmark's 1,000,000-anchor block
      (`bs3d-train-densify`'s table and first view: 10,035,200 rows).

The forward must equal the plain float32 path bit for bit in the fields,
the radii and the cull radii. The backward's error against float64 (the
norm of the difference over the norm of the float64 gradient, leaf by
leaf) must be no larger than twice the plain float32 path's. Skipped
without a CUDA device. The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_project_cuda.py
"""
import numpy as np
import pytest
import torch

from horizongs_tpu_torch.data.synthetic import lookat_camera
from horizongs_tpu_torch.ops import project3d
from horizongs_tpu_torch.ops.reference import ALPHA_CUTOFF
from horizongs_tpu_torch.tools.profile_project import (
    backward_errors,
    forward_mismatch,
    within_twice_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from horizongs_tpu_torch.device import disable_tf32
    disable_tf32()
    return torch.device("cuda")


def _edge_rows(n=100_000, seed=7):
    """Rows around a camera at (0, 0, -4) looking at the origin, a tenth
    of them on each edge."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3))
    quats = rng.normal(size=(n, 4))
    scales = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), (n, 3)))
    op = rng.uniform(0.0, 1.0, n)
    e = n // 10
    means[0:e, 2] = -4.0 + rng.uniform(-0.3, 0.03, e)           # near plane
    means[e:2 * e, 0] = rng.choice([-1, 1], e) * rng.uniform(6, 60, e)
    scales[2 * e:3 * e, 0] = 10.0 ** rng.uniform(3, 4.5, e)      # det <= 0
    scales[2 * e:3 * e, 1:] = 10.0 ** rng.uniform(-7, -5, (e, 2))
    quats[3 * e:4 * e] *= 10.0 ** rng.uniform(-3, 3, (e, 1))
    quats[4 * e:4 * e + e // 2] *= 10.0 ** rng.uniform(-15, -11, (e // 2, 1))
    quats[4 * e + e // 2:5 * e] = 0.0
    op[5 * e:6 * e] = rng.uniform(0.0, ALPHA_CUTOFF, e)
    op[6 * e:6 * e + 100] = np.float32(ALPHA_CUTOFF)
    means[7 * e:8 * e, 1] = rng.choice([-1, 1], e) * rng.uniform(1.4, 2.5, e)
    rgb = rng.uniform(0, 1, (n, 3))
    probe = rng.normal(size=(n, 2)) * 0.01
    return [torch.from_numpy(a.astype(np.float32))
            for a in (means, quats, scales, op, rgb, probe)]


def _project(inputs, cam, w, h):
    return project3d.project_fields_3dgs(*inputs[:4], lambda: inputs[4],
                                         cam.viewmat, cam.K, w, h, inputs[5])


def _plain(inputs, cam, w, h):
    return project3d.project_fields_3dgs_plain(
        *inputs[:4], lambda: inputs[4], cam.viewmat, cam.K, w, h, inputs[5])


def _check_forward(kern, plain):
    for name, (n_off, big) in forward_mismatch(kern, plain).items():
        assert n_off == 0, (f"{name}: {n_off} rows differ from the plain "
                            f"path, largest difference {big}")


def _check_backward(inputs, cam, w, h, seed, keep=None):
    """Each leaf's error against float64, kernel and plain, over all rows
    and, where `keep` is given, over those rows alone."""
    sets = {"all": slice(None)}
    if keep is not None:
        sets["kept"] = keep
    errors = backward_errors(inputs, cam, w, h, seed, sets)
    for label, report in errors.items():
        print(f"backward error against float64, {label} rows "
              f"(kernel, plain, kernel's largest difference): {report}")
    assert within_twice_plain(errors), errors


def test_project_edges_match_plain(card):
    w, h = 640, 360
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    inputs = [x.to(card) for x in _edge_rows()]
    project3d.KERNEL.launches = 0
    kern = _project(inputs, cam, w, h)
    assert project3d.KERNEL.launches == 1
    plain = _plain(inputs, cam, w, h)
    torch.cuda.synchronize()
    _check_forward(kern, plain)
    # every edge is really there
    e = inputs[0].shape[0] // 10
    f, radii = kern.fields, kern.radii
    assert (radii[0:e] == 0).float().mean() > 0.5          # near plane
    assert (radii[e:2 * e] == 0).all()                      # beside the view
    band = f[2 * e:3 * e]                                   # det rounds <= 0
    assert (band[:, 2] * band[:, 4] - band[:, 3] ** 2 <= 0).any()
    assert (kern.cull[5 * e:6 * e] == 0).all()              # below the cutoff
    off = radii[7 * e:8 * e]                                # boxes off-image
    assert (off == 0).any() and (off > 0).any()
    # the band whose covariance rounds to det <= 0 in float32 is another
    # function in float64: held over all rows, and without it
    keep = torch.ones(inputs[0].shape[0], dtype=torch.bool, device=card)
    keep[2 * e:3 * e] = False
    _check_backward(inputs, cam, w, h, seed=11, keep=keep)


def test_project_edges_without_colour_or_probe(card):
    """A count's call: no colour (zero columns), no probe; and without a
    gradient nothing is saved."""
    w, h = 320, 200
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    inputs = [x.to(card) for x in _edge_rows(20_000, seed=3)]
    args = (*inputs[:4], None, cam.viewmat, cam.K, w, h)
    with torch.no_grad():
        kern = project3d.project_fields_3dgs(*args)
    plain = project3d.project_fields_3dgs_plain(*args)
    _check_forward(kern, plain)
    assert (kern.fields[:, 6:9] == 0).all()
    assert kern.fields.grad_fn is None


def test_project_refuses_other_dtypes_on_the_card(card):
    """CUDA inputs always take P1, which takes float32 alone: a float64
    call on the card is refused, not sent down the plain path."""
    w, h = 64, 48
    cam = lookat_camera(width=w, height=h, eye=(0, 0, -4), device=card)
    inputs = [x.to(card, torch.float64) for x in _edge_rows(1000, seed=5)]
    with pytest.raises(ValueError, match="float32"):
        project3d.project_fields_3dgs(
            *inputs[:4], lambda: inputs[4], cam.viewmat.double(),
            cam.K.double(), w, h, inputs[5])


def test_project_block_view_matches_plain(card):
    """One decoded view of the benchmark's block: 10,035,200 rows."""
    from hgsbench import program, scene
    from hgsbench import run as hrun
    from horizongs_tpu_torch.render import decode_view
    spec = hrun.resolve(hrun.load_manifest(), "bs3d-train-densify")
    gen = torch.Generator(device=card)
    gen.manual_seed(2300000001)
    tables = scene.make_tables(spec.cfg, spec.traffic["table"], gen, card)
    views = scene.make_views(spec.cfg, gen, card)
    cam = program.cameras(views)[0]
    mcfg = program.model_config(spec.cfg)
    with torch.no_grad():
        dec = decode_view(cam, mcfg, program.decoders(tables),
                          program.anchor_state(tables))
    del tables
    n = dec.means.shape[0]
    assert n == 10_035_200
    inputs = [dec.means, dec.quats, dec.scales, dec.opacities,
              dec.colors.reshape(n, 3),
              torch.zeros((n, 2), dtype=torch.float32, device=card)]
    w, h = cam.width, cam.height
    kern = _project(inputs, cam, w, h)
    plain = _plain(inputs, cam, w, h)
    torch.cuda.synchronize()
    _check_forward(kern, plain)
    assert (kern.radii > 0).sum() > n // 10
    del kern, plain
    _check_backward(inputs, cam, w, h, seed=5)
