"""The mesh's one-rank groups and `tools/mesh_check` (the card's mesh
harness) on the CPU, with gloo: the helpers and tolerances of
`test_torch_parallel.py`."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from horizongs_tpu_torch.config import make_optim
from horizongs_tpu_torch.models.config import ModelConfig
from test_torch_parallel import (
    FLAT_ED,
    OKW,
    ROOT,
    H,
    W,
    _assert_grads_close,
    _grad_leaves,
    _port_cts,
    _scene,
    _single,
)

torch.set_num_threads(1)


def test_one_rank_collectives_are_identity(tmp_path):
    """In a world of one rank (a 1x1 mesh under torch.distributed), every
    collective is the identity and makes no call, and the 1x1 band step
    equals the single-device step with none."""
    import torch.distributed as dist
    from horizongs_tpu_torch.parallel import collectives as col
    from horizongs_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, shard_state)
    ts_j, ts_t, cams, images = _scene(FLAT_ED)
    ct = _port_cts(cams, images, [1], [1.0])[0]
    loss, grads, _, _ = _single(FLAT_ED, ts_t, ct, 3)
    init_distributed(0, 1, f"file://{tmp_path / 'store'}", device="cpu")
    try:
        mesh = make_mesh(1, 1, device="cpu")
        g = mesh.group("model")
        assert col.trivial(g) and col.trivial(mesh.group("data"))
        x = torch.arange(6.0).reshape(3, 2)
        col.reset_stats()
        for fn in (col.all_to_all, col.all_reduce_sum, col.all_gather,
                   col.pmax, col.reduce_sum):
            assert fn(x, g) is x
        y = col.gather_rows(x, g)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        assert col.broadcast(x) is x
        step = build_sharded_train_step(ModelConfig(**FLAT_ED),
                                        make_optim(**OKW), mesh, H, W,
                                        add_prefilter=False)
        got, _, _, g1, _ = step.value_and_grad(shard_state(ts_t, mesh),
                                               [ct], 3)
        assert col.STATS["ops"] == {}
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    _assert_grads_close(_grad_leaves(g1), _grad_leaves(grads), "1x1")


def test_mesh_check_rehearsal_on_cpu(tmp_path):
    """`tools/mesh_check` (the card's mesh harness) through
    `torch.distributed.run` on the CPU at a small size: a band case and a
    duplicated-view case held to the single-device step at the trainer's
    calibrated capacities (nothing dropped), each rank's record written,
    the band's instances as counted, and the captured kernel arguments
    those of the band (its rows, its records)."""
    import json
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "horizongs_tpu_torch.tools.mesh_check",
         "--device", "cpu", "--size", "64x48", "--points", "300",
         "--steps", "1", "--case", "1x2", "--case", "2x1:duplicate",
         "--capture", "1x2", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert all(r["backend"] == "gloo" for r in ranks)
    for name in ("1x2", "2x1:duplicate"):
        c0 = ranks[0]["cases"][name]
        assert c0["held"] and c0["grad_worst_share_of_max"] <= 2e-4
        for r in ranks:
            c = r["cases"][name]
            assert c["n_instances"] == c["band_instances_counted"]
            assert c["n_instances"] <= c["instance_cap"]
            assert (c["band_cap"] is None) == (name == "2x1:duplicate")
            assert c["dropped"] == 0 and max(c["dropped_timed"]) == 0
            assert c["launches_grad"] == [0, 0]     # the plain versions
    assert len(ranks[0]["cases"]["1x2"]["band_loads"]) == 2
    for r in range(2):
        cap = torch.load(out / f"capture_1x2_rank{r}.pt", weights_only=False)
        assert cap["gs"] == "3D"
        fields, n_ty = cap["fwd"][0], cap["fwd"][4]
        assert fields.shape[1] == 10 and fields.is_contiguous()
        assert n_ty == 2            # a 32-row band and 5 halo rows each side
    assert not (out / "capture_2x1_duplicate_rank0.pt").exists()
