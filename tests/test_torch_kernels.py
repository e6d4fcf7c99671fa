"""The kernels' plain versions (the CPU path of each wrapper) against the
JAX package's Pallas functions in interpret mode, and scipy for the STFT.

Inputs are made by numpy from a seed and fed to both. float32 on both sides
with sums in another order: 2e-4 relative to max|ref|. The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from seld_tpu.ops.pallas.attention import flash_attention as jflash
from seld_tpu.ops.pallas.conv2d_pool import (
    conv2d_smallcin_thin_bn_relu_fpool,
    conv2d_widecin_ct_bn_relu_fpool,
)
from seld_tpu.ops.pallas.stft import stft_mag_pallas
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.attention import flash_attention
from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_bn_relu_fpool
from seld_tpu_torch.ops.kernels.stft import n_frames, stft_mag

F32_TOL = 2e-4  # x max|ref|


def _close(got, want, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


@pytest.mark.parametrize("n", [12345, 32000])
def test_stft_matches_pallas_and_scipy(rng, n):
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    got = stft_mag(torch.from_numpy(x), out_dtype=torch.float32).numpy()
    assert got.shape == (2, 3, n_frames(n, 512, 112), 256)
    want = stft_mag_pallas(jnp.asarray(x), out_dtype=jnp.float32, interpret=True)
    _close(got, want)
    # scipy.signal.stft, as the reference featurizer calls it (DC bin and
    # last frame cut); float64 there, so the same 2e-4 bound
    _, _, z = scipy.signal.stft(x[1, 2].astype(np.float64), window="hamming",
                                nperseg=512, noverlap=112)
    _close(got[1, 2], np.abs(z)[1:, :-1].T)


def test_stft_bf16_output_rounds_the_f32_result(rng):
    """bfloat16 output is the float32 result rounded once (the JAX bf16 path
    computes its DFT in bf16 and is held at bf16 tolerance instead)."""
    x = torch.from_numpy(rng.standard_normal((2, 9000)).astype(np.float32))
    f32 = stft_mag(x, out_dtype=torch.float32)
    bf16 = stft_mag(x, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def _conv_inputs(rng, b, cin, f, t, cout):
    x = rng.standard_normal((b, cin, f, t)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = rng.standard_normal(cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("cin,cout,f,t,pf", [(8, 16, 16, 40, 8), (5, 24, 8, 33, 2)])
def test_conv_smallcin_matches_pallas_thin(rng, cin, cout, f, t, pf):
    x, w, scale, bias = _conv_inputs(rng, 2, cin, f, t, cout)
    got = conv2d_bn_relu_fpool(*map(torch.from_numpy, (x, w, scale, bias)), pf).numpy()
    want = conv2d_smallcin_thin_bn_relu_fpool(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), pool_f=pf, interpret=True,
    )  # (B, F/pf, T, Cout)
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("c,cout,f,t,pf", [(16, 16, 8, 40, 2), (8, 24, 8, 96, 4)])
def test_conv_widecin_matches_pallas_ct(rng, c, cout, f, t, pf):
    x, w, scale, bias = _conv_inputs(rng, 2, c, f, t, cout)
    got = conv2d_bn_relu_fpool(*map(torch.from_numpy, (x, w, scale, bias)), pf).numpy()
    # CT layout (B, F, C, T_pad), columns >= t zero by contract
    h_ct = np.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 0), (0, 24)))
    out_ct = conv2d_widecin_ct_bn_relu_fpool(
        jnp.asarray(h_ct), t, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        pool_f=pf, interpret=True,
    )  # (B, F/pf, Cout, tpad)
    _close(got, np.asarray(out_ct)[..., :t].transpose(0, 2, 1, 3))


@pytest.mark.parametrize("d", [16, 48])
def test_flash_attention_matches_pallas(rng, d):
    q, k, v = (rng.standard_normal((2, 96, 2, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), scale)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                  block_q=32, block_k=32, interpret=True)
    _close(out.numpy(), want)
    s = np.einsum("nqhd,nkhd->nhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    m = s.max(-1, keepdims=True)
    _close(lse.numpy(), (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0])


@pytest.mark.parametrize("call", ["stft_odd_nperseg", "conv_w_shape", "conv_pool",
                                  "attn_shapes", "attn_dtypes"])
def test_wrappers_reject_bad_inputs(call):
    x = torch.zeros(2, 8, 16, 10)
    w = torch.zeros(3, 3, 8, 4)
    s = torch.ones(4)
    q = torch.zeros(1, 10, 2, 16)
    cases = {
        "stft_odd_nperseg": lambda: stft_mag(torch.zeros(2, 1000), nperseg=511, noverlap=111),
        "conv_w_shape": lambda: conv2d_bn_relu_fpool(x, w[:, :, :4], s, s, 2),
        "conv_pool": lambda: conv2d_bn_relu_fpool(x, w, s, s, 3),
        "attn_shapes": lambda: flash_attention(q, q[:, :5], q, 0.25),
        "attn_dtypes": lambda: flash_attention(q, q.double(), q, 0.25),
    }
    with pytest.raises((ValueError, TypeError)):
        cases[call]()
