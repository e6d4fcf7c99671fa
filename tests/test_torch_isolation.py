"""The port stands alone: no module of ``seld_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``seld_tpu``
(the card's host has no JAX).

Checks: every import statement, read with ``ast``; a fresh interpreter
that imports the port's entry points (the ``.seldpak`` reader and the
``parallel`` modules among them) and then finds neither ``jax`` nor
``seld_tpu`` in ``sys.modules``; a fresh interpreter that reads the
repository's ``seld_tpu`` checkpoint into a port model and then finds none of
``jax``, ``jaxlib``, ``flax``, ``optax`` or ``seld_tpu``; and nothing of the
port names or maps the JAX package's native loader (``seld_tpu/data/native``):
the port reads ``.seldpak`` files through its own ``loader.cc``, built into
``seld_tpu_torch/_build/``.
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
        "import seld_tpu_torch.training.jax_checkpoint, seld_tpu_torch.utils.torch_import\n"
        "import seld_tpu_torch.data.native, seld_tpu_torch.parallel\n"
        "import seld_tpu_torch.parallel.dp_step, seld_tpu_torch.parallel.multihost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(' '.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


def test_reading_a_seld_tpu_checkpoint_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from seld_tpu_torch.config import SELDConfig\n"
        "from seld_tpu_torch.models.seld import model_from_config\n"
        "from seld_tpu_torch.training.checkpoint import load_model_weights\n"
        "cfg = SELDConfig(domain='Q', input_channels=8, freq_dim=16, time_dim=16,\n"
        "                 cnn_filters=[8, 8, 8], pool_size=[[2, 2], [2, 2], [2, 2]], D=[2],\n"
        "                 G=8, U=8, V=[16, 16], fc_layers=[16], use_bias_conv=False,\n"
        "                 pool_time='TCN', attention_impl='full')\n"
        "load_model_weights(sys.argv[2], model_from_config(cfg))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(' '.join(bad))\n"
    )
    ckpt = (ROOT / "RESULTS_Original" / "Task2" / "seldnet_augmented"
            / "QSELD-TCN-PHI-S1_BN_RF5_2RB" / "checkpoint_best_model")
    proc = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT), str(ckpt)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


NATIVE = ROOT / "seld_tpu" / "data" / "native"


def _literals(path: Path):
    """(line, text) of every string constant of ``path`` but its docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_opens_the_jax_packages_native_loader(path):
    names = ("seld_tpu/data/native", "seld_tpu.data.native", "libseldio.so", "data/native/")
    bad = [f"{path.name}:{line} {text!r}" for line, text in _literals(path)
           if any(n in text for n in names)]
    assert not bad, bad


def test_the_literal_walk_skips_docstrings_only(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('"""seld_tpu/data/native"""\ndef f():\n    """libseldio.so"""\n'
                     '    return "seld_tpu/data/native/libseldio.so"\n')
    assert [line for line, _ in _literals(probe)] == [4]


def test_reading_a_seldpak_maps_only_the_ports_library(tmp_path):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "from seld_tpu_torch.data.native import PakReader, write_pak\n"
        "write_pak(sys.argv[2], [np.arange(12, dtype=np.float32).reshape(4, 3)])\n"
        "with PakReader(sys.argv[2]) as r:\n"
        "    assert r.gather(0, np.array([2, 0])).tolist() == [[6, 7, 8], [0, 1, 2]]\n"
        "    maps = [l.split()[-1] for l in open('/proc/self/maps') if 'libseldio' in l]\n"
        "print(' '.join(sorted(set(maps))))\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT),
                           str(tmp_path / "t.seldpak")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    maps = proc.stdout.split()
    assert maps and all(m.startswith(str(ROOT / "seld_tpu_torch" / "_build") + "/")
                        for m in maps), maps
    assert not any(m.startswith(str(NATIVE)) for m in maps), maps
