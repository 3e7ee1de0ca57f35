"""`tools/profile_sh.backward_split` on the CPU: on a traced step of a
tiny model every backward node is traced to the span of the forward op
that made it (SH colours' nodes to `render.sh`, an RGB model's to no
such span), and on a hand-built trace each device operation lands in
its part: the forward's span, the backward node's forward span, the
engine, `AccumulateGrad`, the update and the trainer's own work."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.tools.profile_sh import backward_split
from horizongs_tpu_torch.train import step as tstep
from test_torch_tracing import H, W, _cameras, _model

torch.set_num_threads(1)


def _traced_step(tmp_path, **model):
    cfg, state, mlps = _model(**model)
    ts = tstep.init_train_state(state, mlps)
    degree = 2 if model.get("color_attr") == "SH2" else None
    step = tstep.build_train_step(cfg, make_optim(iterations=2000), H, W,
                                  active_sh_degree=degree)
    cam = _cameras()[1]
    cam = tstep.camera_tensors(cam, image=cam.image, do_stats=True)
    ts, _ = step(ts, cam, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(ts, cam, 2)
    tracing.reset()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return backward_split(str(path))


@pytest.mark.parametrize("colour", ["SH2", "RGB"])
def test_every_node_is_traced_to_its_forward_span(tmp_path, colour):
    model = (dict(color_attr="SH2", view_dim=0) if colour == "SH2"
             else {})
    r = _traced_step(tmp_path, **model)
    assert r["steps"] == 1
    parts = set(r["nodes"])
    assert "unmatched" not in parts
    assert {"render.decode", "render.bin", "render.project",
            "render.composite", "step.forward", "accumulate"} <= parts
    # no device on the CPU: the node counts hold, every ms is 0
    assert not any(r[k] for k in ("forward", "backward", "update", "other"))
    if colour == "RGB":
        assert "render.sh" not in parts
        return
    sh = {name: n for name, _, n in r["nodes"]["render.sh"]}
    # degree 2: the nine coefficients taken one by one, each a select
    assert sh["SelectBackward0"] >= 9 and sh["MulBackward0"] > 0
    assert all(ms == 0 for rows in r["nodes"].values() for _, ms, _ in rows)


def _x(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace():
    """One step: the main thread (1) runs the forward, with an SH op
    (external id 1, the maker of node 7) in `render.sh` inside
    `render.bin` and a decode op (2, node 8) in `render.decode`, then
    waits in `step.backward` while autograd's thread (2) evaluates nodes
    7 and 8, adds outside a node and accumulates a leaf; then the update
    and the trainer's pick. Each op launches one kernel."""
    node = "autograd::engine::evaluate_function: "
    ev = [
        _x("trainer.pick", "user_annotation", 0, 5, 1),
        _x("aten::index", "cpu_op", 1, 1, 1, **{"External id": 10}),
        _x("step.forward", "user_annotation", 10, 40, 1),
        _x("render.decode", "user_annotation", 11, 9, 1),
        _x("aten::mm", "cpu_op", 12, 2, 1, **{"External id": 2,
                                               "Sequence number": 8}),
        _x("render.bin", "user_annotation", 21, 19, 1),
        _x("render.sh", "user_annotation", 22, 8, 1),
        _x("aten::mul", "cpu_op", 23, 2, 1, **{"External id": 1,
                                                "Sequence number": 7}),
        # another op of the same sequence number, outside `render.sh`
        _x("aten::view", "cpu_op", 31, 1, 1, **{"External id": 3,
                                                 "Sequence number": 7}),
        _x("aten::sum", "cpu_op", 45, 1, 1, **{"External id": 4}),
        _x("step.backward", "user_annotation", 60, 40, 1),
        _x(node + "MulBackward0", "cpu_op", 61, 10, 2,
           **{"Sequence number": 7}),
        _x("aten::mul", "cpu_op", 62, 2, 2, **{"External id": 5}),
        _x("aten::add_", "cpu_op", 66, 2, 2, **{"External id": 6}),
        _x(node + "MmBackward0", "cpu_op", 72, 10, 2,
           **{"Sequence number": 8}),
        _x("aten::mm", "cpu_op", 73, 2, 2, **{"External id": 7}),
        _x("aten::add", "cpu_op", 84, 1, 2, **{"External id": 8}),
        _x(node + "torch::autograd::AccumulateGrad", "cpu_op", 86, 5, 2,
           **{"Sequence number": 2 ** 64 - 1}),
        _x("aten::add_", "cpu_op", 87, 1, 2, **{"External id": 9}),
        _x("step.update", "user_annotation", 110, 10, 1),
        _x("aten::_foreach_mul_", "cpu_op", 111, 1, 1,
           **{"External id": 11}),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "tid": 1,
         "pid": 1, "ts": 23},
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 2, "tid": 1,
         "pid": 1, "ts": 12},
    ]
    # kernel k of external id k lasts k ms
    ev += [_x(f"kernel{k}", "kernel", 200 + 20 * k, 1000 * k, 7,
              **{"External id": k}) for k in range(1, 12)]
    ev.append(_x("Memset", "gpu_memset", 500, 500, 7, **{"External id": 6}))
    return {"traceEvents": ev}


def test_each_device_operation_lands_in_its_part():
    r = backward_split(_trace())
    assert r["steps"] == 1
    assert r["forward"] == {"render.sh": 1.0, "render.decode": 2.0,
                            "render.bin": 3.0, "step.forward": 4.0}
    assert r["backward"] == {"render.sh": 5.0 + 6.0 + 0.5,
                             "render.decode": 7.0, "engine": 8.0,
                             "accumulate": 9.0}
    assert r["update"] == {"step.update": 11.0}
    assert r["other"] == {"trainer.pick": 10.0}
    assert r["nodes"]["render.sh"] == [["MulBackward0", 11.5, 1.0]]
    assert r["nodes"]["render.decode"] == [["MmBackward0", 7.0, 1.0]]


def test_a_trace_without_a_backward_is_refused():
    ev = _trace()["traceEvents"]
    with pytest.raises(ValueError):
        backward_split({"traceEvents": [e for e in ev
                                        if e["name"] != "step.backward"]})
