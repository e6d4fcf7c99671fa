"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips where torch has no CUDA device (this module
imports neither JAX nor the JAX package, so it also runs on a host without
them: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py``). Shapes span several blocks in every tiled
dimension and end in a ragged tail. Tolerances relative to max|ref|: float32
2e-4 (TF32 off, sums in another order), bfloat16 2e-2 (~2.5 ulps: the plain
versions round at other points).
"""

import pytest
import torch

import seld_tpu_torch
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_plain
from seld_tpu_torch.ops.kernels.conv2d_pool import (
    conv2d_bn_relu_fpool, conv2d_bn_relu_fpool_plain,
)
from seld_tpu_torch.ops.kernels.stft import stft_mag, stft_mag_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seld_tpu_torch.disable_tf32()
    reset_launch_counts()
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    tol = TOL[dtype] * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,nperseg,noverlap", [((3, 40_000), 512, 112),
                                                    ((2, 37_123), 480, 80)])
def test_stft_kernel(gen, dtype, shape, nperseg, noverlap):
    x = torch.randn(*shape, generator=gen, device="cuda")
    got = stft_mag(x, nperseg, noverlap, out_dtype=dtype)
    assert launch_counts["stft_mag"] == 1
    _close(got, stft_mag_plain(x, nperseg, noverlap, out_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,cout,pf", [(2, 5, 24, 300, 80, 8), (2, 8, 8, 130, 64, 2),
                                               (2, 24, 12, 300, 80, 4), (1, 16, 4, 129, 200, 2)])
def test_conv_kernel(gen, dtype, b, cin, f, t, cout, pf):
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = conv2d_bn_relu_fpool(x, w, scale, bias, pf)
    name = "conv3x3_smallcin" if cin <= 8 else "conv3x3_widecin"
    assert launch_counts[name] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,d", [(2, 200, 3, 48), (1, 130, 2, 32), (1, 65, 1, 16)])
def test_flash_attention_kernel(gen, dtype, b, t, h, d):
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    out, lse = flash_attention(q, k, v, d ** -0.5)
    assert launch_counts["flash_attn_fwd"] == 1
    out_ref, lse_ref = flash_attention_plain(q, k, v, d ** -0.5)
    _close(out, out_ref, dtype)
    _close(lse, lse_ref, torch.float32)


def test_cuda_tensors_never_take_the_plain_path(gen):
    """A CUDA tensor launches or raises: mixed devices and unsupported shapes
    raise instead of running the plain version."""
    x = torch.randn(1, 12, 8, 20, generator=gen, device="cuda")
    w = torch.randn(3, 3, 12, 8, device="cuda")
    s = torch.ones(8, device="cuda")
    with pytest.raises(ValueError):   # Cin 12: neither <= 8 nor a multiple of 8
        conv2d_bn_relu_fpool(x, w, s, s, 2)
    with pytest.raises(ValueError):
        conv2d_bn_relu_fpool(x[:, :8], w[:, :, :8].cpu(), s, s, 2)
    q = torch.randn(1, 10, 2, 24, device="cuda")
    with pytest.raises(ValueError):   # head dim 24 has no instantiation
        flash_attention(q, q, q, 0.2)
    assert all(v == 0 for v in launch_counts.values())
