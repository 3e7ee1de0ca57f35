"""The seeded generators: the same seed gives the same inputs, another
seed other inputs, and the layout (so the amount of work) stays."""
from __future__ import annotations

import torch

from hgsbench import scene, view
from hgsbench.tests import tiny

torch.set_num_threads(1)


def make(seed: int, cell: str = "bs3d-train-densify"):
    spec = tiny.spec(cell)
    g = torch.Generator()
    g.manual_seed(seed)
    return spec, scene.make_tables(spec.cfg, spec.traffic["table"], g, "cpu"), g


def test_tables_repeat_for_a_seed_and_differ_across_seeds():
    _, a, _ = make(2 ** 31 + 11)
    _, b, _ = make(2 ** 31 + 11)
    _, c, _ = make(2 ** 31 + 12)
    for x, y, z in zip(a[:7], b[:7], c[:7]):
        assert torch.equal(x, y)
    assert not torch.equal(a.feat, c.feat)
    assert not torch.equal(a.anchor, c.anchor)
    assert a.n == c.n == tiny.SCENE["anchors"]
    assert a.anchor.shape == c.anchor.shape
    for k in a.mlp:                     # the decoders: one for every seed
        assert all(torch.equal(x, y) for x, y in zip(a.mlp[k], b.mlp[k]))
        assert all(torch.equal(x, y) for x, y in zip(a.mlp[k], c.mlp[k]))


def test_table_layout_levels_and_padding():
    spec, t, _ = make(3)
    n, C = t.n, t.anchor.shape[0]
    assert C == scene.round_capacity(n)
    assert torch.all(t.anchor[n:] == 0) and torch.all(t.feat[n:] == 0)
    assert torch.all(t.rotation[:, 0] == 1)
    levels = torch.bincount(t.level[:n]).tolist()
    assert len(levels) == spec.cfg["model"]["aerial_levels"]
    assert levels[-1] > levels[0]            # finer levels hold more anchors


def test_views_repeat_and_differ():
    spec, _, g = make(5)
    v1 = scene.make_views(spec.cfg, g, "cpu")
    _, _, g2 = make(5)
    v2 = scene.make_views(spec.cfg, g2, "cpu")
    _, _, g3 = make(6)
    v3 = scene.make_views(spec.cfg, g3, "cpu")
    assert torch.equal(v1.viewmat, v2.viewmat)
    assert torch.equal(v1.image, v2.image)
    assert not torch.equal(v1.image, v3.image)
    n_a, n_s = tiny.SCENE["aerial_views"], tiny.SCENE["street_views"]
    assert v1.is_aerial == [True] * n_a + [False] * n_s
    assert float(v1.image.min()) >= 0 and float(v1.image.max()) <= 1


def test_flight_repeats_and_spans_aerial_to_street():
    spec = tiny.spec("bs3d-view-fly")

    def fly(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return view.start_from(view.flight(spec.cfg, spec.traffic), g)
    a, b, c = fly(9), fly(9), fly(10)
    assert a == b and a != c
    # every seed sends the same frames, from another start
    i = c.index(a[0])
    assert c[i:] + c[:i] == a
    per = spec.traffic["frames_per_leg"]
    assert len(a) == per * spec.traffic["legs"]
    import numpy as np
    from hgsbench import wire
    z = [float(np.linalg.inv(wire.parse_request(r)["viewmat"])[2, 3])
         for r in a]
    assert max(z) > 50 * min(z)         # from orbit down to the street
