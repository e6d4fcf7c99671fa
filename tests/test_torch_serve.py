"""The serving entry on the CPU (each kernel's plain version), and the rule
that the port never loads JAX."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from seld_tpu_torch.serve import build_flagship, serve

ROOT = Path(__file__).resolve().parent.parent

_NO_JAX_SCRIPT = """
import sys
import numpy as np
import torch
import seld_tpu_torch
from seld_tpu_torch.serve import build_flagship, serve
from seld_tpu_torch.utils import jax_bridge
from seld_tpu_torch.models import fused_infer, seld
model = build_flagship(sys.argv[1], torch.float32, "cpu", torch.Generator().manual_seed(0))
audio = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 12800), dtype=np.float32))
sed, doa = serve(model, audio)
assert sed.shape == (1, 4, 42), sed.shape
assert "jax" not in sys.modules and "flax" not in sys.modules
print("no-jax ok")
"""


def _tiny_config_file(tmp_path) -> Path:
    """The flagship config with widths cut (CNN 16, G = U = V = 16, 3 ResBlocks)."""
    text = (ROOT / "config" / "DQSELD-TCN-S1-PHI_8ch.txt").read_text()
    for old, new in (("[192,192,192]", "[16,16,16]"), ("--G=384", "--G=16"),
                     ("--U=384", "--U=16"), ("[384,384]", "[16,16]"),
                     ("--fc_layers=[384]", "--fc_layers=[16]"), ("--D=[10]", "--D=[3]")):
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "tiny.txt"
    path.write_text(text)
    return path


def test_port_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(_tiny_config_file(tmp_path))],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no-jax ok" in proc.stdout


def test_serve_cpu_outputs(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = build_flagship(_tiny_config_file(tmp_path), torch.bfloat16, "cpu", gen)
    audio = torch.randn(2, 8, 12800, generator=gen)
    sed, doa = serve(model, audio)
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    assert bool(torch.isfinite(sed).all() and torch.isfinite(doa).all())
    assert bool(((sed >= 0) & (sed <= 1)).all() and ((doa >= -1) & (doa <= 1)).all())
    # the bf16 serving path stays near the float32 unfused model on the same weights
    from seld_tpu_torch.ops.kernels.stft import stft_mag_plain

    feats = stft_mag_plain(audio, out_dtype=torch.float32).transpose(-1, -2)
    with torch.no_grad():
        sed_ref, doa_ref = model(feats.contiguous())
    assert (sed - sed_ref).abs().max() < 0.04 and (doa - doa_ref).abs().max() < 0.04
