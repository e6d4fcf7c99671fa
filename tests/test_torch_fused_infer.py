"""The port's serving slice against the JAX package's.

audio -> port STFT (plain, the CPU path of K1) -> port ``fused_infer``
against audio -> ``stft_mag_pallas(interpret=True)`` -> JAX
``fused_infer(interpret=True)``, on the same weights. Tiny DQ config with
the flagship's frequency path: F = 256 (nperseg 512), pools 8 / 8 / 2,
n = 12800 samples (T = 32), CNN (8, 16, 16), one stack of 3 ResBlocks,
G = U = 16. The JAX model uses ``attention_impl='full'`` (its 'auto' path
calls the flash kernel without interpret mode).

Tolerances: float32, 1e-4 (the same sums in another order through a
well-conditioned tiny net). bfloat16, 0.04 on sigmoid / tanh outputs: the
JAX bf16 path computes its DFT in bf16 and rounds at other points than the
port, as in tests/test_pallas.py::test_fused_infer_bf16_ct_chain_matches_apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.models.fused_infer import fused_infer as jax_fused_infer
from seld_tpu.ops.pallas.stft import stft_mag_pallas
from seld_tpu_torch.models.fused_infer import fused_infer
from seld_tpu_torch.models.layers import BatchNorm
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels.stft import stft_mag
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.test_torch_model import random_variables, tiny_config

N_SAMPLES = 12800   # -> T = 32 frames
TOL = {"float32": 1e-4, "bfloat16": 0.04}


def slice_config(compute_dtype="float32"):
    return tiny_config(freq_dim=256, time_dim=32, cnn_filters=[8, 16, 16],
                       pool_size=[[8, 2], [8, 2], [2, 2]], D=[3], G=16, U=16,
                       domain_classifier="DQ", compute_dtype=compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_infer_matches_jax_serving_slice(rng, compute_dtype):
    cfg = slice_config(compute_dtype)
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, 8, 256, 32), rng, dtype=np.float32)
    audio = rng.standard_normal((2, 8, N_SAMPLES)).astype(np.float32)

    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    featurize = lambda a: stft_mag_pallas(a, out_dtype=jdt, interpret=True)
    sed_ref, doa_ref = jax.jit(lambda v, a: jax_fused_infer(
        jmodel, v, a, interpret=True, input_layout="BCTF", featurize=featurize,
    ))(variables, jnp.asarray(audio))

    model = model_from_config(cfg)
    from_jax_variables(variables, model)
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    sed, doa = fused_infer(model, torch.from_numpy(audio), input_layout="BCTF",
                           featurize=lambda a: stft_mag(a, out_dtype=tdt))
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    assert sed.dtype == doa.dtype == torch.float32
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=TOL[compute_dtype])


@pytest.mark.parametrize("domain,bias", [("DQ", False), ("Q", True), ("R", True)])
def test_fused_infer_matches_port_model(domain, bias):
    """Folding and merging change no output: fused_infer (float32) against
    the unfused eval model on the same features, 1e-5 (float32 sums in
    another order). Also BCFT and BCTF layouts agree."""
    gen = torch.Generator().manual_seed(0)
    model = model_from_config(slice_config().replace(domain=domain, use_bias_conv=bias,
                                                     domain_classifier="same"),
                              generator=gen)
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        bn.var.uniform_(0.5, 1.5, generator=gen)
        bn.mean.normal_(0.0, 0.1, generator=gen)
    if bias:
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.data.normal_(0.0, 0.1, generator=gen)
    x = torch.rand(2, 8, 256, 32, generator=gen)
    with torch.no_grad():
        want = model(x)
    got_ft = fused_infer(model, x)
    got_tf = fused_infer(model, x.transpose(2, 3).contiguous(), input_layout="BCTF")
    for g1, g2, w in zip(got_ft, got_tf, want):
        torch.testing.assert_close(g1, w, rtol=0, atol=1e-5)
        torch.testing.assert_close(g2, g1, rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_infer_wide_matches_jax_serving_slice(rng, compute_dtype):
    """smallcin_impl='wide': stage 1 (Cin 8) through the wide pack (K2w's
    plain version here, the Pallas smallcin kernel on the JAX side)."""
    cfg = slice_config(compute_dtype)
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, 8, 256, 32), rng, dtype=np.float32)
    audio = rng.standard_normal((2, 8, N_SAMPLES)).astype(np.float32)

    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    featurize = lambda a: stft_mag_pallas(a, out_dtype=jdt, interpret=True)
    sed_ref, doa_ref = jax.jit(lambda v, a: jax_fused_infer(
        jmodel, v, a, interpret=True, input_layout="BCTF", featurize=featurize,
        smallcin_impl="wide",
    ))(variables, jnp.asarray(audio))

    model = model_from_config(cfg)
    from_jax_variables(variables, model)
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    sed, doa = fused_infer(model, torch.from_numpy(audio), input_layout="BCTF",
                           featurize=lambda a: stft_mag(a, out_dtype=tdt), smallcin_impl="wide")
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=TOL[compute_dtype])


@pytest.mark.parametrize("cin", [10, 12])
def test_fused_infer_general_cin_matches_jax(rng, cin):
    """R-domain models with 10 and 12 input channels, float32: stage 1 on
    K2w (Cin 10; the Pallas smallcin kernel in JAX) and on K10b (Cin 12; an
    XLA conv in JAX), stage 2 (Cin 8) on K2, stage 3 (Cin 16) on K3."""
    cfg = tiny_config(domain="R", input_channels=cin, cnn_filters=[8, 16, 16])
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, cin, 32, 32), rng, dtype=np.float32)
    x = rng.random((2, cin, 32, 32)).astype(np.float32)
    sed_ref, doa_ref = jax.jit(lambda v, a: jax_fused_infer(jmodel, v, a, interpret=True))(
        variables, jnp.asarray(x))
    model = model_from_config(cfg)
    from_jax_variables(variables, model)
    sed, doa = fused_infer(model, torch.from_numpy(x))
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_fused_infer_rejects_an_unknown_smallcin_impl():
    model = model_from_config(slice_config())
    with pytest.raises(ValueError, match="smallcin_impl"):
        fused_infer(model, torch.zeros(1, 8, 256, 32), smallcin_impl="auto")
