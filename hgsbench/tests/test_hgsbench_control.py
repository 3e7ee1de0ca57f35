"""The control of `correct`, on a card at the cell's own size: the
reference in the program's place one precision below the
configuration's (TF32) fails at least one of the cell's limits on each of
three seeds. (At the tests' tiny sizes TF32 moves too little to tell.)
The benchmark's own runs never run it; by hand it is `python3 -m
hgsbench.control --workload <cell> --seeds ...`."""
from __future__ import annotations

import pytest
import torch

from hgsbench import control
from hgsbench import run as hrun


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bs3d-train-densify", "bs2d-train-tail",
                                  "bs3d-view-fly"])
def test_control_fails_a_limit_on_every_seed(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    spec = hrun.resolve(hrun.load_manifest(), cell)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        nums = control.readings(spec, seed, torch.device("cuda", 0))
        ok, checks = hrun.judge(nums, spec.limits)
        assert not ok, (seed, checks)
