"""The plain reference: it imports neither the program nor JAX, and at a
tiny size on the CPU (where the program, too, runs its plain
compositors) it agrees with the program."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from hgsbench import program, scene
from hgsbench import run as hrun
from hgsbench.reference import check
from hgsbench.reference import render as ref_render
from hgsbench.tests import tiny

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]


def test_reference_and_yardstick_import_nothing_of_the_program():
    code = ("import sys; import hgsbench.reference.check, "
            "hgsbench.reference.densify, hgsbench.counts, "
            "hgsbench.trace, hgsbench.scene, hgsbench.wire, hgsbench.client, "
            "hgsbench.capture, hgsbench.readers; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = eval(out)
    assert not {"jax", "jaxlib", "flax", "horizongs_tpu",
                "horizongs_tpu_torch"} & set(tops)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "horizongs_tpu_torch_fake", object())
    assert "horizongs_tpu" not in hrun.forbidden_modules()
    monkeypatch.setitem(sys.modules, "horizongs_tpu.fake", object())
    assert hrun.forbidden_modules() == ["horizongs_tpu"]


def _scene(seed=4):
    spec = tiny.spec("bs3d-train-densify")
    g = torch.Generator()
    g.manual_seed(seed)
    t = scene.make_tables(spec.cfg, spec.traffic["table"], g, "cpu")
    v = scene.make_views(spec.cfg, g, "cpu")
    return spec, t, v


def test_reference_render_agrees_with_the_program():
    from horizongs_tpu_torch.render import render
    spec, t, v = _scene()
    cams = program.cameras(v)
    mcfg, rcfg = program.model_config(spec.cfg), check.model_config(spec.cfg)
    host = scene.host_copy(t)
    for i in (0, len(cams) - 1):          # an aerial and a street view
        with torch.no_grad():
            a = render(cams[i], mcfg, program.decoders(t),
                       program.anchor_state(t), torch.zeros(3))
            cam = ref_render.Camera(viewmat=v.viewmat[i], K=v.K[i],
                                    width=v.width, height=v.height,
                                    cam_center=v.center[i])
            b = ref_render.render(cam, rcfg, check.decoders_of(host, "cpu"),
                                  check.state_of(host, "cpu"),
                                  torch.zeros(3))
        assert int(b["n_dropped"]) == 0
        assert torch.allclose(a["render"], b["render"], atol=1e-6)
        assert torch.equal(a["visible_mask"], b["visible_mask"])


def test_reference_training_step_agrees_with_the_program():
    from horizongs_tpu_torch.train.step import build_train_step, camera_tensors
    spec, t, v = _scene(5)
    host = scene.host_copy(t)
    _, op, _ = program.namespaces(spec.cfg)
    cam = program.cameras(v)[1]
    ts = program.init_train_state(program.anchor_state(t),
                                  program.decoders(t))
    step = build_train_step(program.model_config(spec.cfg), op, v.height,
                            v.width)
    loss, _, _, grads, _ = step.value_and_grad(
        ts, camera_tensors(cam, do_stats=True), 1501.0)
    ref = check.train_steps(spec.cfg, host, v, [(1501, 1)], 1.0, "cpu")
    assert abs(float(loss) - ref["losses"][0]) <= 1e-6 * ref["losses"][0]
    norms = [float(torch.linalg.norm(g.double()))
             for gs in grads.values() for g in gs]
    for a, b in zip(norms, ref["grad_norms"]):
        assert abs(a - b) <= 1e-5 * max(b, 1e-12)


def test_reference_epoch_agrees_with_the_program():
    from horizongs_tpu_torch.train.densify import run_densify
    from hgsbench import capture
    from hgsbench.reference import densify as ref_densify
    spec, t, _ = _scene(6)
    ts = program.init_train_state(program.anchor_state(t),
                                  program.decoders(t))
    # statistics that grow some offsets on each level and prune anchors
    g = torch.Generator()
    g.manual_seed(7)
    ck = ts.stats.offset_denom.shape[0]
    C = ts.stats.anchor_demon.shape[0]
    od = torch.randint(0, 160, (ck,), generator=g).float()
    demon = torch.randint(0, 200, (C,), generator=g).float()
    ts = ts._replace(stats=ts.stats._replace(
        offset_denom=od,
        offset_gradient_accum=od * 8e-4 * torch.rand(ck, generator=g),
        anchor_demon=demon,
        anchor_opacity_accum=demon * 0.01 * torch.rand(C, generator=g)))
    _, op, _ = program.namespaces(spec.cfg)
    snap = {k: v.clone() for k, v in capture._epoch_inputs(ts).items()}
    snap["n"] = int(ts.n)
    out = run_densify(program.model_config(spec.cfg), op, ts, 1601,
                      stage="coarse")
    prog = dict(capture._tables(out, int(out.n)), n=int(out.n))
    ref = ref_densify.epoch(check.model_config(spec.cfg),
                            check.optim(spec.cfg), snap, "cpu")
    assert ref["added"] > 0 and ref["pruned"] > 0
    assert ref_densify.rows_off(prog, ref) == 0.0
    prog["feat"] = prog["feat"].clone()
    prog["feat"][int(out.n) - 1, 0] += 1.0      # one grown row altered
    assert ref_densify.rows_off(prog, ref) > 0.0
