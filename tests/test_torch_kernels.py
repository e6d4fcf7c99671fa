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
    # The plain version runs on the float32 audio widened to float64: its DFT
    # is then exact on every host. In float32 it is one CPU GEMM of depth
    # 512, whose error depends on the host's BLAS: on one test host the port's
    # values moved by up to 2.1e-4 of max|ref| (the bound) while the Pallas
    # side did not move at all. The float32 branch is the same code
    # (test_stft_bf16_output_rounds_the_f32_result; the card's kernel is
    # held to it in tests/test_torch_cuda.py).
    got = stft_mag(torch.from_numpy(x).double(), out_dtype=torch.float32).numpy()
    assert got.shape == (2, 3, n_frames(n, 512, 112), 256)
    want = stft_mag_pallas(jnp.asarray(x), out_dtype=jnp.float32, interpret=True)
    _close(got, want)
    # scipy.signal.stft, as the reference featurizer calls it (DC bin and
    # last frame cut); float64 there, so the same 2e-4 bound
    _, _, z = scipy.signal.stft(x[1, 2].astype(np.float64), window="hamming",
                                nperseg=512, noverlap=112)
    _close(got[1, 2], np.abs(z)[1:, :-1].T)


def _gemm_bound(x, want, nperseg=512, noverlap=112):
    """What two float32 DFT products of depth nperseg over the audio x may
    differ by at each output element (want the magnitudes): per side and per
    real or imaginary part, gamma_(nperseg+1) * S with S the sum of |audio|
    x |table column| over the frame (gamma_k = k u / (1 - k u), u = 2**-24,
    any summation order, the extra 1 for the table's own rounding), times
    sqrt(2) for the magnitude, plus 2 u of it for the last square, sum and
    root."""
    hop = nperseg - noverlap
    t = n_frames(x.shape[-1], nperseg, noverlap)
    right = max(0, (t - 1) * hop + nperseg // 2 - x.shape[-1])
    padded = np.pad(np.abs(x.astype(np.float64)), ((0, 0), (0, 0), (nperseg // 2, right)))
    frames = np.lib.stride_tricks.sliding_window_view(padded, nperseg, axis=-1)[..., ::hop, :][
        ..., :t, :]
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    s = frames @ (win / win.sum())                                   # (2, 3, T): max |column|
    u = 2.0 ** -24
    gamma = (nperseg + 1) * u / (1 - (nperseg + 1) * u)
    return 2 * (np.sqrt(2.0) * gamma * s[..., None] + 2 * u * np.abs(want))


@pytest.mark.parametrize("n", [12345, 32000])
def test_stft_float32_matches_pallas_within_the_gemm_bound(rng, n):
    """The plain version's float32 branch against the Pallas kernel, each
    element within :func:`_gemm_bound`."""
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    got = stft_mag(torch.from_numpy(x), out_dtype=torch.float32).numpy()
    want = np.asarray(stft_mag_pallas(jnp.asarray(x), out_dtype=jnp.float32, interpret=True))
    bound = _gemm_bound(x, want)
    err = np.abs(got.astype(np.float64) - want)
    assert got.shape == want.shape == bound.shape
    assert (err <= bound).all(), (err.max(), float((err / bound).max()))


def test_stft_bf16_output_rounds_the_f32_result(rng):
    """bfloat16 output: the plain version's bf16 branch against the Pallas
    kernel's bf16 output on the same audio. Both round the frames and the
    table to bf16 and sum the exact products in float32 (``stft.py:389``),
    then round the float32 magnitude to bf16 once: each element within the
    float32 GEMM bound (:func:`_gemm_bound`, times (1 + 2**-8)**2: a bf16
    operand is within 2**-8 of its float value, so the |audio| x |table|
    sums grow by at most that) plus one bf16 ulp of the result (2**-7
    relative: two float32 values that close can round to neighbouring bf16
    values)."""
    x = rng.standard_normal((2, 3, 9000)).astype(np.float32)
    got = stft_mag(torch.from_numpy(x), out_dtype=torch.bfloat16)
    want = np.asarray(stft_mag_pallas(jnp.asarray(x), out_dtype=jnp.bfloat16, interpret=True)
                      .astype(jnp.float32), np.float64)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().astype(np.float64)
    bound = (1 + 2.0 ** -8) ** 2 * _gemm_bound(x, want) + 2.0 ** -7 * np.abs(want)
    err = np.abs(got - want)
    assert got.shape == want.shape == bound.shape
    assert (err <= bound).all(), (err.max(), float((err / bound).max()))
    # the operands' rounding shows: float32 audio and table give other bf16 values
    f32 = stft_mag(torch.from_numpy(x), out_dtype=torch.float32).to(torch.bfloat16)
    assert not torch.equal(f32.float(), torch.from_numpy(got).float())


@pytest.mark.parametrize("nperseg", [512, 488, 480])
def test_dft_table_tiles_hold_the_bf16_table(nperseg):
    """The bf16 kernel's tiled table: tile j, tap k holds the float32 table's
    cos then sin columns of bins 64 j .. 64 j + 63 rounded to bf16, zero past
    nperseg and past the last bin."""
    from seld_tpu_torch.ops.kernels.stft import TC_BINS, TC_TAPS, dft_table, dft_table_tiles

    tiles = dft_table_tiles(nperseg, "cpu")
    table = dft_table(nperseg, "cpu").to(torch.bfloat16)
    n_bins = nperseg // 2
    n_tiles, k_pad = -(-n_bins // TC_BINS), -(-nperseg // TC_TAPS) * TC_TAPS
    assert tiles.shape == (n_tiles, k_pad, 2 * TC_BINS) and tiles.dtype == torch.bfloat16
    want = torch.zeros(n_tiles, k_pad, 2 * TC_BINS, dtype=torch.bfloat16)
    for f in range(n_bins):
        want[f // TC_BINS, :nperseg, f % TC_BINS] = table[:, f]
        want[f // TC_BINS, :nperseg, TC_BINS + f % TC_BINS] = table[:, n_bins + f]
    assert torch.equal(tiles, want)


@pytest.mark.parametrize("cin", [1, 5, 8, 9])
def test_smallcin_pool_limit_is_the_launched_kernels(cin):
    """K2's pool_f limit per halo staging is the launched kernel's: in bf16
    at Cin <= 8 the tensor-core kernel's (the largest pool_f whose pool_f +
    2 halo rows of 4 channel-pair rows of 168 words and 80 x 72 bf16
    weights fit 232,448 bytes), in bf16 at Cin 9 the SIMT kernel's; in
    float32 the float smallcin tile's (pool_f + 2 rows of CC x 136 floats
    beside the split weights, two planes of 9 x 4 x 32 x 4 words a chunk of
    8 channels, and 4 x 64 floats of columns)."""
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool

    top = pool.smallcin_max_pool_f(cin, torch.bfloat16)
    cc = 8 if cin <= 8 else 16
    fits32 = lambda pf: 4 * ((pf + 2) * cc * 136 + 2 * (cc // 8) * 4608 + 256) <= 232_448
    top32 = pool.smallcin_max_pool_f(cin)
    assert top32 == pool.float_tile_max_pool_f(cin) == (42 if cin <= 8 else 16)
    assert fits32(top32) and not fits32(top32 + 1)
    if cin > 8:
        assert top == pool.halo_max_pool_f(cin) == 21
        return
    fits = lambda pf: 4 * (pf + 2) * 4 * 168 + 2 * 80 * 72 <= 232_448
    assert fits(top) and not fits(top + 1) and top == 80


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
