"""K1's float32 FFT kernel (``csrc/stft_mag.cu::stft_mag_fft_kernel``) as a
CPU mirror of its plan, against the port's plain version, the JAX
``stft_mag_pallas`` in interpret mode and scipy; and the wrapper's route.

The mirror takes the kernel's steps in torch with explicit butterflies, not
``torch.fft``: the same float64-built tables (``stft.fft_tables``), the pairs
z[m] = xw[2m] + i xw[2m+1] of each frame's windowed samples, the Stockham
stages (radix 8, then one of 4 or 2; output in natural order, so no digit
reversal), each butterfly's twiddles W_M^(r (jj % Ns) M / (Ns R)) read from
the N-point table at twice that index, radix 8 as two radix-4 DFTs and a
radix-2 layer, and the real split of bins 1..M. Inputs are drawn by numpy
from a seed. Tolerances relative to max|ref|: 2e-4 in float32 (sums in
another order, as every float32 kernel of the port is held), 1e-10 for the
plan in float64 against scipy's float64 STFT (the plan itself, without
float32 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from seld_tpu.ops.pallas.stft import stft_mag_pallas, stft_mag_supported
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.stft import (
    FFT_NPERSEG, fft_tables, n_frames, stft_mag, stft_mag_plain, stft_route,
)

F32_TOL = 2e-4
F64_TOL = 1e-10
THREADS = 256   # kFftThreads: a block holds THREADS * 8 / M frames
SQRT_HALF = 0.70710678118654752440

# (nperseg, noverlap, n): hops the JAX kernel takes; frame counts ragged
# against the block's 2048 / M frames (T % (2048 / M) != 0); n odd in one case
CASES = [(64, 32, 3001), (256, 128, 8000), (512, 112, 12_345), (1024, 512, 19_777)]


def fft_radices(nperseg: int) -> list:
    """The kernel's stages (``FftStage``): radix 8 while 8 divides what is
    left of M = nperseg / 2, the last one radix 4 or 2."""
    log_m = (nperseg // 2).bit_length() - 1
    count = (log_m + 2) // 3
    return [8 if s < count - 1 or log_m % 3 == 0 else 2 ** (log_m % 3) for s in range(count)]


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _neg_i(a):
    return a[1], -a[0]


def _dft(v):
    """The kernel's in-register DFTs of 2, 4 or 8 points (``dft<R>``)."""
    if len(v) == 2:
        return [_add(v[0], v[1]), _sub(v[0], v[1])]
    if len(v) == 4:
        t0, t1 = _add(v[0], v[2]), _sub(v[0], v[2])
        t2, t3 = _add(v[1], v[3]), _neg_i(_sub(v[1], v[3]))
        return [_add(t0, t2), _add(t1, t3), _sub(t0, t2), _sub(t1, t3)]
    e, d = _dft(v[0::2]), _dft(v[1::2])
    c = SQRT_HALF
    d[1] = (c * (d[1][0] + d[1][1]), c * (d[1][1] - d[1][0]))
    d[2] = _neg_i(d[2])
    d[3] = (c * (d[3][1] - d[3][0]), -c * (d[3][0] + d[3][1]))
    return [_add(e[s], d[s]) for s in range(4)] + [_sub(e[s], d[s]) for s in range(4)]


def fft_plan_mirror(x: torch.Tensor, nperseg: int, noverlap: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """x (rows, n) -> (rows, T, nperseg / 2) magnitudes by the kernel's plan,
    computed in ``dtype`` with its tables in ``dtype``."""
    win, tw = fft_tables(nperseg, "cpu", dtype)
    m_pts, hop, n = nperseg // 2, nperseg - noverlap, x.shape[-1]
    t = n_frames(n, nperseg, noverlap)
    # frame t's samples t * hop - M + j, zero outside [0, n)
    idx = torch.arange(t)[:, None] * hop - m_pts + torch.arange(nperseg)[None, :]
    inside = (idx >= 0) & (idx < n)
    xw = torch.where(inside, x.to(dtype)[:, idx.clamp(0, n - 1)], 0) * win
    z = (xw[..., 0::2], xw[..., 1::2])   # z[m] = xw[2m] + i xw[2m+1]
    ns = 1
    for radix in fft_radices(nperseg):
        jj = torch.arange(m_pts // radix)
        k = jj % ns
        v = [(z[0][..., jj + r * (m_pts // radix)], z[1][..., jj + r * (m_pts // radix)])
             for r in range(radix)]
        for r in range(1, radix):
            w = tw[2 * r * k * (m_pts // (ns * radix))]
            v[r] = _mul(v[r], (w[:, 0], w[:, 1]))
        v = _dft(v)
        out = (torch.empty_like(z[0]), torch.empty_like(z[1]))
        base = (jj // ns) * ns * radix + k
        for s in range(radix):
            out[0][..., base + s * ns] = v[s][0]
            out[1][..., base + s * ns] = v[s][1]
        z, ns = out, ns * radix
    # the split: X[k] = E[k] - i W^k D[k], E / D = (Z[k] +/- Z*[M-k]) / 2
    k = torch.arange(1, m_pts)
    a, c = (z[0][..., k], z[1][..., k]), (z[0][..., m_pts - k], z[1][..., m_pts - k])
    er, ei = 0.5 * (a[0] + c[0]), 0.5 * (a[1] - c[1])
    dr, di = 0.5 * (a[0] - c[0]), 0.5 * (a[1] + c[1])
    wc, ws = tw[k, 0], tw[k, 1]
    xr, xi = er + wc * di + ws * dr, ei - wc * dr + ws * di
    last = (z[0][..., :1] - z[1][..., :1]).abs()   # X[M] = Re Z[0] - Im Z[0]
    return torch.cat([torch.sqrt(xr * xr + xi * xi), last], dim=-1)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain version: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("nperseg,noverlap,n", CASES)
def test_fft_plan_matches_the_plain_version_and_the_pallas_kernel(rng, nperseg, noverlap, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    t = n_frames(n, nperseg, noverlap)
    assert t % (THREADS * 8 // (nperseg // 2)), "frames must be ragged against the block"
    got = fft_plan_mirror(torch.from_numpy(x), nperseg, noverlap, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, t, nperseg // 2)
    # the plain version's DFT on the float32 audio widened to float64 (exact on
    # every host; its table is the float32 one)
    plain = stft_mag_plain(torch.from_numpy(x).double(), nperseg, noverlap,
                           out_dtype=torch.float32)
    _close(got, plain, F32_TOL)
    assert stft_mag_supported(nperseg, noverlap, jnp.float32)
    want = stft_mag_pallas(jnp.asarray(x), nperseg=nperseg, noverlap=noverlap,
                           out_dtype=jnp.float32, interpret=True)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("nperseg,noverlap,n", CASES)
def test_fft_plan_in_float64_matches_scipy(rng, nperseg, noverlap, n):
    """The plan with float64 tables and sums against scipy.signal.stft in
    float64 (DC bin and last frame cut): only rounding separates them."""
    x = rng.standard_normal((2, n))
    got = fft_plan_mirror(torch.from_numpy(x), nperseg, noverlap, torch.float64).numpy()
    _, _, zs = scipy.signal.stft(x, window="hamming", nperseg=nperseg, noverlap=noverlap)
    want = np.abs(zs)[:, 1:, :-1].transpose(0, 2, 1)
    _close(got, want, F64_TOL)


def test_fft_plan_on_bf16_audio(rng):
    """bf16 audio (the kernel widens each sample to float) through the plan
    against the plain version on the same bf16 samples."""
    x = torch.from_numpy(rng.standard_normal((3, 9000)).astype(np.float32)).to(torch.bfloat16)
    got = fft_plan_mirror(x.float(), 512, 112, torch.float32)
    _close(got, stft_mag_plain(x.double(), 512, 112, out_dtype=torch.float32), F32_TOL)


@pytest.mark.parametrize("nperseg", FFT_NPERSEG)
def test_fft_tables_are_the_dft_tables_window_and_float64_twiddles(nperseg):
    win, tw = fft_tables(nperseg, "cpu")
    assert win.dtype == tw.dtype == torch.float32
    assert win.shape == (nperseg,) and tw.shape == (nperseg, 2)
    w64 = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    assert np.array_equal(win.numpy(), (w64 / w64.sum()).astype(np.float32))
    angle = 2.0 * np.pi * np.arange(nperseg) / nperseg
    assert np.array_equal(tw.numpy()[:, 0], np.cos(angle).astype(np.float32))
    assert np.array_equal(tw.numpy()[:, 1], (-np.sin(angle)).astype(np.float32))
    w64t, tw64 = fft_tables(nperseg, "cpu", torch.float64)
    assert np.array_equal(w64t.numpy(), w64 / w64.sum())
    assert np.array_equal(tw64.numpy()[:, 1], -np.sin(angle))


@pytest.mark.parametrize("nperseg,want", [
    *((n, "fft") for n in FFT_NPERSEG),
    (480, "simt"), (32, "simt"), (96, "simt"), (4096, "simt"),
])
def test_stft_route_for_float32_output(nperseg, want):
    assert stft_route(nperseg, torch.float32) == want


@pytest.mark.parametrize("nperseg", [64, 480, 512, 2048])
def test_stft_route_for_bf16_output_is_the_tensor_core_kernel(nperseg):
    assert stft_route(nperseg, torch.bfloat16) == "tc"


def test_fft_radices_multiply_to_m():
    assert fft_radices(512) == [8, 8, 4]
    for nperseg in FFT_NPERSEG:
        assert int(np.prod(fft_radices(nperseg))) == nperseg // 2


def test_cpu_float32_output_takes_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((2, 5000)).astype(np.float32))
    got = stft_mag(x, 512, 112, out_dtype=torch.float32)
    assert torch.equal(got, stft_mag_plain(x, 512, 112, out_dtype=torch.float32))
