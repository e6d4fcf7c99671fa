"""The port stands alone: no module of ``seld_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``seld_tpu``
(the card's host has no JAX).

Two checks: every import statement, read with ``ast``; and a fresh
interpreter that imports the port's entry points and then finds neither
``jax`` nor ``seld_tpu`` in ``sys.modules``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "seld_tpu")


def _sources():
    return sorted((ROOT / "seld_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_the_walk_sees_every_kind_of_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nimport jax.numpy as jnp\nfrom seld_tpu.config import x\n"
                     "def f():\n    from seld_tpu_torch import y\n    import seld_tpu\n")
    assert [m for _, m in _imports(probe) if _forbidden(m)] == [
        "jax.numpy", "seld_tpu.config", "seld_tpu"]


def test_importing_the_entry_points_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import seld_tpu_torch.serve, seld_tpu_torch.training, seld_tpu_torch.data.synthetic\n"
        "import seld_tpu_torch.utils.jax_bridge, seld_tpu_torch.ops.kernels.conv2d_train\n"
        "import seld_tpu_torch.train, seld_tpu_torch.training.trainer\n"
        "import seld_tpu_torch.ops.kernels.conv2d_ct_train\n"
        "import seld_tpu_torch.predict, seld_tpu_torch.ops.kernels.qmatmul\n"
        "import seld_tpu_torch.ops.kernels.quant, seld_tpu_torch.profile_stages\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(' '.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"
