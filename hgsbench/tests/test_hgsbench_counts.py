"""The yardstick's counts on hand-worked cases: walked and contributing
pairs, bytes, the least time, the decoders' FLOPs and the trace's busy
union."""
from __future__ import annotations

import json
import math

import pytest
import torch

from hgsbench import counts, trace

torch.set_num_threads(1)


def flat_fields(opacities):
    """Gaussians at the centre of one 32x32 tile with a zero conic (alpha
    = opacity at every pixel)."""
    f = torch.zeros((len(opacities), 10))
    f[:, 0:2] = 16.0
    f[:, 5] = torch.tensor(opacities)
    return f


def test_pairs_stop_at_each_pixels_transmittance():
    # alpha 0.999 (the cap) twice: after the first, log T = log 1e-3 is
    # above log 1e-4, so each pixel walks the second; after it, not the
    # third
    f = flat_fields([0.999, 0.999, 0.999])
    p = counts.count_pairs("3d", f, torch.arange(3, dtype=torch.int32),
                           torch.tensor([0, 3], dtype=torch.int32), 1)
    assert p == counts.Pairs(walked=2 * 1024, contributing=2 * 1024,
                             rows=3, instances=3, tiles=1)


def test_pairs_below_the_cutoff_are_walked_not_contributing():
    f = flat_fields([0.5 / 255, 0.5])
    p = counts.count_pairs("3d", f, torch.arange(2, dtype=torch.int32),
                           torch.tensor([0, 2], dtype=torch.int32), 1)
    assert p.walked == 2 * 1024 and p.contributing == 1024


def test_bytes_ops_and_least_time():
    p = counts.Pairs(walked=1000, contributing=400, rows=10, instances=12,
                     tiles=2)
    assert counts.call_ops("k1", p) == (15 * 1000 + 14 * 400,
                                        1000 + 2 * 400)
    assert counts.call_ops("k2", p) == (16 * 1000 + 40 * 400,
                                        1000 + 3 * 400)
    # rows x 10 floats, the list and the starts, 8 output floats a pixel
    assert counts.call_bytes("k1", p) == (10 * 10 * 4 + 4 * (12 + 3)
                                          + 4 * 8 * 2 * 1024)
    # backward: the rows read and their gradients written
    assert counts.call_bytes("k2", p) == (2 * 10 * 10 * 4 + 4 * (12 + 3)
                                          + 4 * 8 * 2 * 1024)
    sfu = counts.sfu_rate(132, 1.98e9)
    least = counts.least_seconds("k1", p, sfu)
    assert least == max(counts.call_bytes("k1", p) / 3.35e12,
                        (15 * 1000 + 14 * 400) / 67e12,
                        (1000 + 2 * 400) / sfu)


def test_decoder_flops_per_anchor():
    model = {"feat_dim": 32, "n_offsets": 10, "view_dim": 3,
             "appearance_dim": 0, "color_attr": "RGB"}
    # opacity 35->32->10, cov 35->32->70, colour 35->32->30
    assert counts.mlp_flops_per_anchor(model) == (
        2 * (35 * 32 + 32 * 10) + 2 * (35 * 32 + 32 * 70)
        + 2 * (35 * 32 + 32 * 30))
    p = counts.Pairs(100, 50, 1, 1, 1)
    assert counts.step_flops(model, 7, {"k1": p}, train=False) == (
        7 * 13760 + 15 * 100 + 14 * 50)
    assert counts.step_flops(model, 7, {}, train=True) == 3 * 7 * 13760


@pytest.mark.parametrize("attr,per_row", [
    ("RGB", 0),
    ("SH0", 0 + 2 * 3 * 1),       # the constant basis, 3 multiply-adds
    ("SH1", 3 + 2 * 3 * 4),       # C1 x, y, z
    ("SH2", 18 + 2 * 3 * 9),      # and 6 products, 5 values (9 operations)
    ("SH3", 48 + 2 * 3 * 16),     # and 7 values (30 operations)
])
def test_sh_evaluation_flops(attr, per_row):
    model = {"feat_dim": 32, "n_offsets": 10, "view_dim": 0,
             "appearance_dim": 4, "color_attr": attr}
    assert counts.sh_flops_per_row(model) == per_row
    mlp = counts.mlp_flops_per_anchor(model)
    assert counts.step_flops(model, 7, {}, train=False) == 7 * (
        mlp + 10 * per_row)
    assert counts.step_flops(model, 7, {}, train=True) == 3 * 7 * (
        mlp + 10 * per_row)
    if attr != "RGB":
        # the colour decoder: 36 -> 32 -> 3(d+1)^2 x 10; the others 32 in
        color = 10 * 3 * (int(attr[2]) + 1) ** 2
        assert mlp == (2 * (32 * 32 + 32 * 10) + 2 * (32 * 32 + 32 * 70)
                       + 2 * (36 * 32 + 32 * color))
        # at a lower active degree, that degree's count
        assert counts.sh_flops_per_row(model, degree=0) == 6
    else:
        assert counts.sh_flops_per_row(model, degree=None) == 0


def test_percent_has_nothing_to_divide_by():
    assert counts.percent(1.0, 0.0) is None
    assert counts.percent(1.0, 4.0) == 25.0


def test_trace_busy_is_the_union_over_streams(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::step", "ts": 0,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "raster3d_fwd_kernel(x)",
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "nccl_allreduce", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20,
         "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 31,
         "dur": 9},
        {"ph": "X", "cat": "kernel", "name": "raster3d_fwd_kernel(x)",
         "ts": 40, "dur": 2},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = trace.read(str(path))
    assert t.busy_s == pytest.approx(22e-6)          # 0-15, 20-25, 40-42
    assert t.window_s == pytest.approx(42e-6)
    assert trace.kernel_calls(t, "raster3d_fwd") == [10e-6, 2e-6]
    gaps = dict(t.idle_gaps)
    assert gaps["aten::step"] == pytest.approx(10e-6)    # 15-20, 25-30
    assert gaps["python"] == pytest.approx(1e-6)         # 30-31
    assert gaps["aten::item"] == pytest.approx(9e-6)     # 31-40
    assert math.isclose(sum(v for _, v in t.device_ops), 27e-6)


def test_trace_without_device_work_raises(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 1}]}))
    with pytest.raises(RuntimeError):
        trace.read(str(path))
