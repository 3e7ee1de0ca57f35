"""Port parity, the committed configs: every YAML under
`configs/{base,matrix_city,synthetic}` loads equal through both packages'
`load_yaml`, `parse_cfg` (the three namespaces with their defaults) and
the CLIs' `load_config` (the model config and the resolved model path).
`tests/test_configs.py` holds their reference values on the JAX side."""
import dataclasses
from pathlib import Path

import pytest

from horizongs_tpu import config as jconfig
from horizongs_tpu.cli.common import load_config as j_load_config
from horizongs_tpu_torch import config as tconfig
from horizongs_tpu_torch.cli.common import load_config as t_load_config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
YAMLS = sorted(str(p.relative_to(CONFIGS))
               for d in ("base", "matrix_city", "synthetic")
               for p in (CONFIGS / d).rglob("*.yaml"))


def test_the_ten_committed_configs():
    assert len(YAMLS) == 10


@pytest.mark.parametrize("rel", YAMLS)
def test_config_parses_equal(rel):
    path = str(CONFIGS / rel)
    raw = tconfig.load_yaml(path)
    assert raw == jconfig.load_yaml(path)
    for t, j in zip(tconfig.parse_cfg(raw), jconfig.parse_cfg(raw)):
        assert vars(t) == vars(j)
    (lp, op, pp, cfg), (jlp, jop, jpp, jcfg) = (t_load_config(path),
                                                j_load_config(path))
    assert (vars(lp), vars(op), vars(pp)) == (vars(jlp), vars(jop),
                                              vars(jpp))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
