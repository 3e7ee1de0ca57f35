"""The PyTorch port stands alone: no module of `horizongs_tpu_torch` and
not `chip_smoke.py` imports JAX or anything of the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "horizongs_tpu"}
SOURCES = sorted((ROOT / "horizongs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_top_levels(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_package_imports_with_jax_blocked():
    modules = sorted(
        "horizongs_tpu_torch." + ".".join(
            p.relative_to(ROOT / "horizongs_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "horizongs_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'horizongs_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
