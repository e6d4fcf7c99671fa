"""The export entry point (``seld_tpu_torch/export_serving.py``) and its op
library (``seld_tpu_torch/ops/kernels/library.py``) on the CPU, where each
``seld::`` op runs its kernel's plain version.

- (a) ``torch.library.opcheck`` of every ``seld::`` op at ragged shapes on
  inputs that do not require grad, each fake's shape and dtype against the
  real output (meta tensors), and each CUDA impl refusing CPU tensors;
- (b) export -> save -> load of the fused pipeline in float32 and bfloat16
  and of ``apply`` in float32 under ``qconv_impl`` xla, pallas (K7's plain
  version) and int8 (K8's): the loaded artifact equals the eager port bit
  for bit;
- (c) the artifacts against the JAX package on the same weights
  (``utils/jax_bridge.py::from_jax_variables``), seeded numpy inputs:
  ``apply`` against ``jax.export`` of ``tools/export_serving.py::
  build_pipeline(..., 'apply')`` (the tool loaded by path; float32, 1e-4),
  ``fused`` against JAX ``fused_infer(interpret=True)`` with the Pallas STFT
  in interpret mode, at ``tests/test_torch_fused_infer.py``'s tolerances
  (1e-4 float32; 0.04 bfloat16 on sigmoid / tanh outputs, where the JAX
  path computes its DFT in bf16 and rounds at other points);
- (d) the loaded artifact serves a second seeded weight set through
  ``load_state_dict`` as eager ``serve`` does, and the first again after it;
- (e) the CLI: an export in one process, ``--load --selftest`` in another
  that imports neither the model code, the config system, ``serve`` nor JAX.

Shapes: the tiny flagship config of ``tests/test_torch_serve.py`` (CNN 16,
G = U = V = 16, 3 ResBlocks), batch 2, one second of 8-channel audio (80
STFT frames, 10 output frames). The JAX model takes
``attention_impl='full'``: under 'auto' its ``fused_infer`` calls the Pallas
flash kernel without interpret mode.
"""

import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import load_config as jax_load_config
from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.models.fused_infer import fused_infer as jax_fused_infer
from seld_tpu.ops.pallas.stft import stft_mag_pallas
from seld_tpu_torch.config import load_config
from seld_tpu_torch.export_serving import build_pipeline, resolve_impl
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import attention, conv2d_pool, qmatmul, quant, stft
from seld_tpu_torch.ops.kernels.conv2d_pool import smallcin_pack
from seld_tpu_torch.ops.kernels.quant import quantize_weight_per_channel
from seld_tpu_torch.serve import build_flagship, serve
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.test_torch_model import random_variables
from tests.test_torch_serve import _tiny_config_file

ROOT = Path(__file__).resolve().parents[1]
BATCH, SECONDS, SR = 2, 1, 32000
FRAMES = 80   # STFT frames of one second (hop 400)
TOL = {"float32": 1e-4, "bfloat16": 0.04}
VARIANTS = {  # id: (impl, compute dtype, qconv_impl)
    "fused-f32": ("fused", "float32", "xla"),
    "fused-bf16": ("fused", "bfloat16", "xla"),
    "apply-f32-xla": ("apply", "float32", "xla"),
    "apply-f32-pallas": ("apply", "float32", "pallas"),
    "apply-f32-int8": ("apply", "float32", "int8"),
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---- (a) the ops ----------------------------------------------------------------

def _op_cases():
    """(id, op, args): every seld:: op at shapes ragged against the kernels'
    tiles, in both dtypes where the op takes both."""
    g = torch.Generator().manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g)
    ops = torch.ops.seld
    x, w = randn(2, 5, 24, 13), randn(3, 3, 5, 7)
    scale, bias = torch.rand(7, generator=g) + 0.5, randn(7)
    p0, wk = smallcin_pack(x, w)
    q, k, v = randn(2, 17, 3, 12), randn(2, 17, 3, 12), randn(2, 17, 3, 12)
    x4, comps4, b4 = randn(19, 20), randn(4, 5, 3), randn(12)
    x8, comps8 = randn(19, 24), randn(8, 3, 2)
    w_q, w_s = quantize_weight_per_channel(randn(20, 9))
    cases = [("stft_mag-f32", ops.stft_mag, (randn(2, 3, 1001), 64, 24, torch.float32)),
             ("stft_mag-bf16", ops.stft_mag, (randn(3, 999), 64, 16, torch.bfloat16))]
    cases += [(f"conv3x3_fpool-{kernel}", ops.conv3x3_fpool, (x, w, scale, bias, 3, kernel))
              for kernel in conv2d_pool.FPOOL_KERNELS]
    cases += [("conv3x3_fpool-bf16", ops.conv3x3_fpool,
               (x.bfloat16(), w.bfloat16(), scale, bias, 8, "conv3x3_smallcin")),
              ("smallcin_wide_product", ops.smallcin_wide_product,
               (p0, wk, scale, bias, 3, 13, 5)),
              ("flash_attn_fwd-f32", ops.flash_attn_fwd, (q, k, v, 0.3)),
              ("flash_attn_fwd-bf16", ops.flash_attn_fwd,
               (q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.3)),
              ("hamilton_matmul-q", ops.hamilton_matmul, (x4, comps4, b4, 4, False)),
              ("hamilton_matmul-dq", ops.hamilton_matmul, (x8, comps8, None, 8, True)),
              ("hamilton_matmul-bf16", ops.hamilton_matmul,
               (x4.bfloat16(), comps4.bfloat16(), b4, 4, True)),
              ("int8_matmul-f32", ops.int8_matmul, (x4, w_q, w_s, randn(9))),
              ("int8_matmul-bf16", ops.int8_matmul, (x4.bfloat16(), w_q, w_s, None))]
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("name,op,args", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_opcheck(name, op, args):
    assert not any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name,op,args", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_fake_shapes_and_dtypes_are_the_real_ones(name, op, args):
    real = op(*args)
    fake = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
    real, fake = (real, fake) if isinstance(real, tuple) else ((real,), (fake,))
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]


CUDA_IMPLS = {
    "stft_mag": stft.stft_mag_cuda,
    "conv3x3_fpool": conv2d_pool.conv3x3_fpool_cuda,
    "smallcin_wide_product": conv2d_pool.smallcin_wide_product_cuda,
    "flash_attn_fwd": attention.flash_attention_cuda,
    "hamilton_matmul": qmatmul.hamilton_matmul_cuda,
    "int8_matmul": quant.int8_matmul_cuda,
}


@pytest.mark.parametrize("op_name", sorted(CUDA_IMPLS))
def test_cuda_impls_refuse_cpu_tensors(op_name):
    """No fallback: a CUDA impl given CPU tensors raises before it builds or
    launches anything (the dispatcher sends it CUDA tensors only)."""
    args = next(a for name, _, a in OP_CASES if name.startswith(op_name))
    with pytest.raises(ValueError, match="CPU tensors"):
        CUDA_IMPLS[op_name](*args)


# ---- shared artifacts ------------------------------------------------------------

@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return _tiny_config_file(tmp_path_factory.mktemp("cfg"))


@pytest.fixture(scope="module")
def audio():
    return np.random.default_rng(1).standard_normal((BATCH, 8, SR * SECONDS)).astype(np.float32)


def _jax_model(cfg_path, compute_dtype):
    return jax_model_from_config(jax_load_config(str(cfg_path)).replace(
        compute_dtype=compute_dtype, attention_impl="full"))


@pytest.fixture(scope="module")
def variables(cfg_path):
    """The JAX weights every variant's port model is bridged from."""
    return random_variables(_jax_model(cfg_path, "float32"), (1, 8, 256, FRAMES),
                            np.random.default_rng(0), dtype=np.float32)


@pytest.fixture(scope="module")
def exported(cfg_path, variables, audio):
    """variant id -> (port config, eager pipeline, loaded artifact module),
    exported at the audio's shape, saved and loaded once per module."""
    cache = {}

    def get(vid):
        if vid not in cache:
            impl, dtype, qconv = VARIANTS[vid]
            cfg = load_config(str(cfg_path)).replace(compute_dtype=dtype, qconv_impl=qconv)
            model = model_from_config(cfg)
            from_jax_variables(variables, model)
            pipeline = build_pipeline(cfg, model.eval(), impl)
            program = torch.export.export(pipeline, (torch.from_numpy(audio),), strict=False)
            program.example_inputs = None
            buf = io.BytesIO()
            torch.export.save(program, buf)
            buf.seek(0)
            cache[vid] = cfg, pipeline, torch.export.load(buf).module()
        return cache[vid]

    return get


# ---- (b) the loaded artifact against the eager port ------------------------------

@pytest.mark.parametrize("vid", list(VARIANTS))
def test_loaded_artifact_equals_the_eager_port(exported, audio, vid):
    _, pipeline, artifact = exported(vid)
    x = torch.from_numpy(audio)
    with torch.no_grad():
        want = pipeline(x)
        got = artifact(x)
    assert got[0].shape == (BATCH, 10, 42) and got[1].shape == (BATCH, 10, 126)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


# ---- (c) the artifact against the JAX package ------------------------------------

@pytest.fixture(scope="module")
def jax_apply(cfg_path, variables, audio):
    """(sed, doa) of ``jax.export`` of the JAX tool's apply pipeline, float32."""
    spec = importlib.util.spec_from_file_location("jax_export_serving_tool",
                                                  ROOT / "tools" / "export_serving.py")
    tool = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):   # the tool sets its cache variables on import
        spec.loader.exec_module(tool)
    jcfg = jax_load_config(str(cfg_path)).replace(attention_impl="full")
    pipeline = tool.build_pipeline(jcfg, jax_model_from_config(jcfg), "apply")
    exp = jax.export.export(jax.jit(pipeline))(variables, jnp.asarray(audio))
    return [np.asarray(o, np.float32) for o in exp.call(variables, jnp.asarray(audio))]


@pytest.mark.parametrize("vid", ["apply-f32-xla", "apply-f32-pallas"])
def test_apply_artifact_matches_the_jax_export(exported, jax_apply, audio, vid):
    _, _, artifact = exported(vid)
    with torch.no_grad():
        got = artifact(torch.from_numpy(audio))
    for g, w in zip(got, jax_apply):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL["float32"])


@pytest.mark.parametrize("vid", ["fused-f32", "fused-bf16"])
def test_fused_artifact_matches_jax_fused_infer(cfg_path, exported, variables, audio, vid):
    compute_dtype = VARIANTS[vid][1]
    jmodel = _jax_model(cfg_path, compute_dtype)
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    featurize = lambda a: stft_mag_pallas(a, out_dtype=jdt, interpret=True)
    want = jax.jit(lambda v, a: jax_fused_infer(
        jmodel, v, a, interpret=True, input_layout="BCTF", featurize=featurize,
    ))(variables, jnp.asarray(audio))
    _, _, artifact = exported(vid)
    with torch.no_grad():
        got = artifact(torch.from_numpy(audio))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=0,
                                   atol=TOL[compute_dtype])


# ---- (d) another weight set through load_state_dict -------------------------------

@pytest.mark.parametrize("vid", ["fused-f32", "fused-bf16"])
def test_loaded_artifact_serves_a_second_weight_set(cfg_path, exported, audio, vid):
    cfg, pipeline, artifact = exported(vid)
    dtype = _DTYPES[VARIANTS[vid][1]]
    other = build_flagship(cfg_path, dtype, "cpu", torch.Generator().manual_seed(7))
    x = torch.from_numpy(audio)
    with torch.no_grad():
        want = serve(other, x)
        artifact.load_state_dict(build_pipeline(cfg, other, "fused").state_dict())
        got = artifact(x)
        artifact.load_state_dict(pipeline.state_dict())
        again, first = artifact(x), pipeline(x)
    assert not torch.equal(want[0], first[0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(again, first):
        assert torch.equal(g, w)


# ---- the auto rule and the CLI ----------------------------------------------------

def test_auto_follows_the_jax_tools_rule(cfg_path):
    cfg = load_config(str(cfg_path)).replace(compute_dtype="bfloat16")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_impl(cfg, "auto", cuda) == "fused"
    assert resolve_impl(cfg, "auto", cpu) == "apply"
    assert resolve_impl(cfg.replace(compute_dtype="float32"), "auto", cuda) == "apply"
    # unlike the predict CLI's rule, 2Parallel trunks stay on apply
    assert resolve_impl(cfg.replace(parallel_ConvTC_block="2Parallel"), "auto", cuda) == "apply"
    assert resolve_impl(cfg, "fused", cpu) == "fused"
    with pytest.raises(ValueError, match="impl"):
        resolve_impl(cfg, "xla", cpu)


_LOAD_ONLY = """
import runpy, sys
import torch
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
sys.argv = ["export_serving", "--load", sys.argv[1], "--selftest"]
runpy.run_module("seld_tpu_torch.export_serving", run_name="__main__")
names = ("seld_tpu_torch.models", "seld_tpu_torch.config", "seld_tpu_torch.serve", "jax",
         "seld_tpu")
print("loaded:", sorted(m for m in sys.modules if any(m == n or m.startswith(n + ".")
                                                     for n in names)))
print("tf32:", torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
"""


def test_cli_exports_and_a_process_without_the_model_code_loads(cfg_path, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = tmp_path / "serving.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "seld_tpu_torch.export_serving", f"--TextArgs={cfg_path}",
         "--device", "cpu", "--batch", str(BATCH), "--seconds", str(SECONDS), "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"exported impl=apply device=cpu audio=({BATCH}, 8, {SR * SECONDS})" in proc.stdout
    assert "WARNING: no --checkpoint" in proc.stderr
    assert out.is_file()
    proc = subprocess.run([sys.executable, "-c", _LOAD_ONLY, str(out)], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"audio ({BATCH}, 8, {SR * SECONDS}) float32 on cpu" in proc.stdout
    assert f"selftest ok: [({BATCH}, 10, 42), ({BATCH}, 10, 126)]" in proc.stdout
    assert "loaded: []" in proc.stdout, proc.stdout
    assert "tf32: False False" in proc.stdout, proc.stdout


_SERVING_HOST = """
import torch
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
import seld_tpu_torch.ops.kernels.library
print(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
"""


def test_the_op_library_turns_tf32_off():
    """A serving host's recipe (import the op library, then torch.export.load)
    runs an artifact's float32 convolutions and matmuls outside the kernels
    in full float32: cuDNN's default is TF32, and aten.convolution in the
    graph carries no precision."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _SERVING_HOST], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["False", "False"], proc.stdout

