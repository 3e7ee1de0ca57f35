"""The per-layer readers on hand-made records: epochs, the step's rebuild
after them and the profiler's stretch are kept out of the host and step
readings; a reader with nothing to read returns None."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from hgsbench import run as hrun


def fake_run(traced=None, epochs=(3,)):
    step = [100.0] * 10
    it = [104.0] * 10
    for e in epochs:
        it[e] += 800.0            # the epoch
        it[e + 1] += 200.0        # the rebuild after it
    if traced:
        for i in range(traced[0], traced[1] + 1):
            it[i] += 50.0
            step[i] += 10.0
    out = {"records": {"iteration_ms": it, "step_ms": step,
                       "densify": [{"iteration": 1000 + e} for e in epochs]},
           "window_first": 1000, "traced_rows": traced, "calls": []}
    return SimpleNamespace(kind="train", out=out, trace=None, sfu_rate=None,
                           model={})


@pytest.mark.parametrize("traced", [None, (6, 8)])
def test_host_step_and_densify_readings(traced):
    run = fake_run(traced)
    assert hrun.reader("trainer.host_ms")(run) == pytest.approx(4.0)
    assert hrun.reader("step.ms_p50")(run) == pytest.approx(100.0)
    assert hrun.reader("densify.ms")(run) == pytest.approx(1008.0)


def test_epoch_inside_the_profiler_stretch_is_left_out():
    assert hrun.reader("densify.ms")(fake_run((2, 5))) is None


def test_readers_without_a_trace_return_none():
    run = fake_run()
    for name in ("k1_roofline.train", "k2_roofline", "mfu.train",
                 "device.idle_pct.train", "k1_roofline.view", "mfu.view",
                 "device.idle_pct.view", "view.render_ms_p50"):
        assert hrun.reader(name)(run) is None, name
