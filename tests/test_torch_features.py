"""The port's magnitude + phase featurizer against the JAX package's and scipy.

``seld_tpu_torch.data.features.spectrum_fast`` against
``seld_tpu.data.features.spectrum_fast(method='fft')`` (the JAX package's CPU
route) on seeded 8-channel audio, batched, at nperseg 512 / noverlap 112
(the shipped featurization) and 480 / 80 (a length that is not a power of
two), with and without phase, in the 'CFT' and 'CTF' layouts; and against
``scipy.signal.stft`` (the reference featurizer's call) itself.

Tolerances: the magnitude within 1e-5 x max (float32 FFTs in another
order). The phase as the wrapped difference |angle(exp(i (a - b)))| <= 1e-3
rad, where the magnitude is at least 1e-3 x max: below that the angle of a
float32 spectrum is ill-conditioned, and it flips by 2 pi at the branch cut
(im ~ 0, re < 0). The masked share is printed and asserted to stay under
MASKED_SHARE (0.003% of the bins of this white noise lie below 1e-3 x max).
"""

import jax
import numpy as np
import pytest
import scipy.signal
import torch

from seld_tpu.data.features import hamming_periodic as jax_hamming_periodic
from seld_tpu.data.features import spectrum_fast as jax_spectrum_fast
from seld_tpu.data.features import spectrum_fast_batch as jax_spectrum_fast_batch
from seld_tpu_torch.data import features

SR = 32000
MAG_TOL = 1e-5       # x max|magnitude|
PHASE_TOL = 1e-3     # rad, wrapped
MAG_FLOOR = 1e-3     # x max|magnitude|: phase compared where the magnitude is at least this
MASKED_SHARE = 0.02


def _audio(rng, batch=2, channels=8, seconds=1.0):
    return rng.standard_normal((batch, channels, int(SR * seconds))).astype(np.float32)


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b.astype(np.float64)))))


def _assert_features_close(got, want, channels, phase, layout):
    """got / want (..., C', F, T) or (..., C', T, F): magnitude channels
    first, then phase channels; returns the masked share of the phase bins."""
    assert got.shape == want.shape
    mag_g, mag_w = got[..., :channels, :, :], want[..., :channels, :, :]
    top = np.abs(mag_w).max()
    np.testing.assert_allclose(mag_g, mag_w, rtol=0, atol=MAG_TOL * top)
    if not phase:
        assert got.shape[-3] == channels
        return 0.0
    assert got.shape[-3] == 2 * channels
    ph_g, ph_w = got[..., channels:, :, :], want[..., channels:, :, :]
    assert np.abs(ph_g).max() <= np.pi + 1e-6
    keep = mag_w >= MAG_FLOOR * top
    masked = 1.0 - keep.mean()
    assert masked < MASKED_SHARE, f"{layout}: {masked:.4f} of the phase bins masked"
    d = _wrapped(ph_g, ph_w)[keep]
    assert d.max() <= PHASE_TOL, f"{layout}: phase off by {d.max():.3e} rad"
    return masked


@pytest.mark.parametrize("nperseg,noverlap", [(512, 112), (480, 80)])
@pytest.mark.parametrize("phase", [True, False], ids=["phase", "mag"])
@pytest.mark.parametrize("layout", ["CFT", "CTF"])
def test_spectrum_fast_batch_matches_jax(rng, nperseg, noverlap, phase, layout):
    audio = _audio(rng)
    kw = dict(nperseg=nperseg, noverlap=noverlap, output_phase=phase, return_layout=layout)
    want = np.asarray(jax_spectrum_fast_batch(jax.numpy.asarray(audio), method="fft", **kw))
    got = features.spectrum_fast_batch(torch.from_numpy(audio), **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    bins, frames = nperseg // 2, -(-(SR + 2 * (nperseg // 2) - nperseg) // (nperseg - noverlap))
    fx = (bins, frames) if layout == "CFT" else (frames, bins)
    assert got.shape == (2, 16 if phase else 8, *fx)
    masked = _assert_features_close(got.numpy(), want, 8, phase, layout)
    print(f"nperseg {nperseg}, {layout}: {100 * masked:.3f}% of the phase bins masked")


def test_spectrum_fast_one_clip_defaults_match_jax(rng):
    """One (C, n) clip with every default (noverlap 128, phase on, 'CFT'),
    given as a numpy array."""
    clip = _audio(rng, batch=1)[0]
    want = np.asarray(jax_spectrum_fast(jax.numpy.asarray(clip), method="fft"))
    got = features.spectrum_fast(clip)
    _assert_features_close(got.numpy(), want, 8, True, "CFT")


@pytest.mark.parametrize("nperseg,noverlap", [(512, 112), (480, 80)])
def test_spectrum_fast_matches_scipy_stft(rng, nperseg, noverlap):
    """The reference featurizer (reference utility_functions.py:129-155):
    scipy.signal.stft with a Hamming window, in float64, DC bin and last
    frame cut, magnitude then angle."""
    clip = _audio(rng, batch=1, channels=4)[0]
    _, _, spec = scipy.signal.stft(clip.astype(np.float64), window="hamming",
                                   nperseg=nperseg, noverlap=noverlap)
    spec = spec[:, 1:, :-1]
    want = np.concatenate([np.abs(spec), np.angle(spec)], axis=0)
    got = features.spectrum_fast(clip, nperseg=nperseg, noverlap=noverlap)
    _assert_features_close(got.numpy(), want, 4, True, "CFT")


def test_layouts_are_transposes_and_the_window_is_scipys(rng):
    audio = torch.from_numpy(_audio(rng, batch=1, seconds=0.25))
    cft = features.spectrum_fast_batch(audio, nperseg=512, noverlap=112)
    ctf = features.spectrum_fast_batch(audio, nperseg=512, noverlap=112, return_layout="CTF")
    assert torch.equal(cft, ctf.transpose(-1, -2))
    for n in (480, 512):
        win = features.hamming_periodic(n)
        assert win.dtype == torch.float32
        np.testing.assert_array_equal(win.numpy(), np.asarray(jax_hamming_periodic(n)))
        np.testing.assert_allclose(win.numpy(), scipy.signal.get_window("hamming", n),
                                   rtol=0, atol=1e-7)


def test_frames_are_scipys(rng):
    """stft_frames: the zero boundary of nperseg // 2 and the tail padded to
    whole hops, as scipy frames (its frame count; the first frame half zeros)."""
    x = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    for nperseg, noverlap in ((64, 16), (100, 37), (512, 112)):
        frames = features.stft_frames(x, nperseg, noverlap)
        _, _, spec = scipy.signal.stft(x.numpy(), nperseg=nperseg, noverlap=noverlap)
        assert frames.shape == (3, spec.shape[-1], nperseg)
        half = nperseg // 2
        np.testing.assert_array_equal(frames[:, 0, :half].numpy(), 0.0)
        np.testing.assert_array_equal(frames[:, 0, half:].numpy(), x[:, :nperseg - half].numpy())


def test_spectrum_fast_rejects_what_it_cannot_take(rng):
    with pytest.raises(ValueError, match="return_layout"):
        features.spectrum_fast(_audio(rng, batch=1)[0], return_layout="TF")
    with pytest.raises(ValueError, match="batch, channels, n"):
        features.spectrum_fast_batch(_audio(rng, batch=1)[0])
