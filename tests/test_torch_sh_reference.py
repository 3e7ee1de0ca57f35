"""The port's training step on SH2 colours without a view direction
(view_dim 0, the configuration `mc-block_a-chunk-sh2`: Horizon-GS's
large-scene chunk) against the benchmark's plain reference
(`hgsbench/reference`: plain torch, no port kernel, no JAX), at the
benchmark's tiny CPU size with seeded random tables and decoders, at SH
degrees 0, 1 and 2.

Both sides run float32 on the CPU through the same arithmetic (the port's
compositors run their plain versions on CPU tensors), so they agree to
float32 rounding: each reading may differ by 1e-6 of its size, room for a
sum taken in another order (float32's unit round-off is 6e-8, and the
longest sums here, a pixel's walk and a decoder's 32-wide dot product,
hold tens of terms). Adam's eps of 1e-15 turns a difference in the last
bit of a gradient element that is round-off alone into a whole step of
that element, so the leaves after the three steps are held to the same
1e-6 of their change, which such a flip would exceed."""
from __future__ import annotations

import pytest
import torch

from hgsbench import program, scene
from hgsbench.reference import check
from hgsbench.reference import step as ref_step
from hgsbench.tests import tiny
from horizongs_tpu_torch.train.step import build_train_step, camera_tensors

torch.set_num_threads(1)

CELL = "ba-sh2-train-tail"
SEED = 2 ** 31 + 11
REL = 1e-6


def _close(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= REL * scale + 1e-30, name


def _program(spec, tables, views, picks, degree: int):
    """The port's step over `picks`: (losses, the first gradient, the
    leaves after the last step, the leaf names)."""
    _, op, _ = program.namespaces(spec.cfg)
    cams = program.cameras(views)
    ts = program.init_train_state(program.anchor_state(tables),
                                  program.decoders(tables))
    step = build_train_step(program.model_config(spec.cfg), op,
                            views.height, views.width,
                            spatial_lr_scale=scene.cameras_extent(views),
                            active_sh_degree=degree)
    losses, first = [], None
    for it, v in picks:
        ct = camera_tensors(cams[v], do_stats=False)
        loss, aux, pkg, grads, probe_grad = step.value_and_grad(ts, ct, it)
        if first is None:
            first = [g.clone() for gs in grads.values() for g in gs]
        ts, _ = step.update(ts, ct, it, loss, aux, pkg, grads, probe_grad)
        losses.append(float(loss))
    groups = ts.params.groups()
    return (losses, first, [t.detach().clone() for t in check.leaves(groups)],
            check.leaf_names(groups))


def _reference(spec, host, views, picks, degree: int):
    """The plain reference's step over the same picks, from the host copy
    of the same tables."""
    ts = ref_step.init_train_state(check.state_of(host, "cpu"),
                                   check.decoders_of(host, "cpu"))
    step = ref_step.build_train_step(
        check.model_config(spec.cfg), check.optim(spec.cfg), views.height,
        views.width, spatial_lr_scale=scene.cameras_extent(views),
        active_sh_degree=degree, background=torch.zeros(3))
    losses, first = [], None
    for it, v in picks:
        ct = check._camera(views, v, False)
        loss, aux, pkg, grads, probe_grad = step.value_and_grad(ts, ct, it)
        assert int(pkg["n_dropped"]) == 0
        if first is None:
            first = [g.clone() for gs in grads.values() for g in gs]
        ts, _ = step.update(ts, ct, it, loss, aux, pkg, grads, probe_grad)
        losses.append(float(loss))
    return losses, first, [t.detach().clone()
                           for t in check.leaves(ts.params.groups())]


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_sh2_view0_step_agrees_with_the_plain_reference(degree):
    spec = tiny.spec(CELL)
    model = spec.cfg["model"]
    assert (model["color_attr"], model["view_dim"]) == ("SH2", 0)
    g = torch.Generator()
    g.manual_seed(SEED)
    tables = scene.make_tables(spec.cfg, spec.traffic["table"], g, "cpu")
    views = scene.make_views(spec.cfg, g, "cpu")
    host = scene.host_copy(tables)       # the port's Adam works in place
    initial = [t.clone() for t in (host.anchor, host.offset, host.feat,
                                   host.scaling_log)]
    initial += [t.clone() for name in ("opacity", "cov", "color")
                for t in host.mlp[name]]
    # an aerial view, a street view, an aerial view, past update_until
    first = spec.traffic["first_iter"]
    picks = [(float(first), 1), (float(first + 1), len(views.is_aerial) - 1),
             (float(first + 2), 2)]

    losses, grads, leaves, names = _program(spec, tables, views, picks,
                                            degree)
    ref_losses, ref_grads, ref_leaves = _reference(spec, host, views, picks,
                                                   degree)

    assert abs(losses[0] - ref_losses[0]) <= REL * abs(ref_losses[0])
    assert len(grads) == len(ref_grads) == len(names)
    colour_w2 = names.index("mlp_color.w2")
    assert grads[colour_w2].shape == (model["feat_dim"],
                                      27 * model["n_offsets"])
    for a, b, name in zip(grads, ref_grads, names):
        _close(a, b, name)
    # the colour layer's coefficients up to the degree get a gradient, those
    # beyond it none
    w2 = ref_grads[colour_w2].reshape(model["feat_dim"],
                                      model["n_offsets"], 9, 3)
    n = (degree + 1) ** 2
    assert float(w2[:, :, :n].abs().amax(dim=(0, 1, 3)).min()) > 0.0
    assert not w2[:, :, n:].any()
    for a, b, a0, name in zip(leaves, ref_leaves, initial, names):
        _close(a - a0, b - a0, name)
