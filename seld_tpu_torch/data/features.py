"""STFT magnitude (+ phase) features with scipy's semantics.

The port's counterpart of ``seld_tpu/data/features.py`` (``hamming_periodic``,
``spectrum_fast``, ``spectrum_fast_batch``), which reimplements the
reference featurizer (reference ``utility_functions.py:129-155``, a wrapper
of ``scipy.signal.stft(window='hamming', nperseg, noverlap)``):

- periodic Hamming window (``scipy.signal.get_window`` uses ``sym=False``);
- ``boundary='zeros'``: ``nperseg // 2`` zeros on both ends;
- ``padded=True``: the tail zero-padded to a whole number of hops;
- one-sided real FFT over ``window.sum()``;
- the DC bin and the last frame cut;
- magnitude channels first, then the ``atan2(im, re)`` phase channels.

In the JAX package this is XLA, not a Pallas kernel, so plain torch is its
port: the frames are a strided view, the transform is ``torch.fft.rfft`` in
float32. Phase configs featurize here, on the card as on the CPU: the JAX
package's fused serving path keeps its Pallas STFT (K1, the port's
``ops/kernels/stft.py``) for magnitude-only configs and featurizes phase
configs with ``spectrum_fast`` (root ``predict.py:112-124``), and so does
the port's ``serve``.
"""

from __future__ import annotations

import numpy as np
import torch

LAYOUTS = ("CFT", "CTF")


def hamming_periodic(nperseg: int, device=None) -> torch.Tensor:
    """Periodic Hamming window, float32, identical to
    ``scipy.signal.get_window('hamming', nperseg)`` (built in float64)."""
    n = np.arange(nperseg)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / nperseg)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def stft_frames(x: torch.Tensor, nperseg: int, noverlap: int) -> torch.Tensor:
    """(..., n) -> (..., n_frames, nperseg) as scipy frames it: the zero
    boundary, then the tail padded to whole hops (a strided view of the
    padded copy)."""
    hop = nperseg - noverlap
    half = nperseg // 2
    n = x.shape[-1] + 2 * half
    rem = (-(n - nperseg)) % hop
    xp = torch.nn.functional.pad(x, (half, half + rem))
    return xp.unfold(-1, nperseg, hop)


def spectrum_fast(x, nperseg: int = 512, noverlap: int = 128, cut_dc: bool = True,
                  output_phase: bool = True, cut_last_timeframe: bool = True,
                  return_layout: str = "CFT", device=None) -> torch.Tensor:
    """Multichannel STFT magnitude (+ phase) features, float32.

    x: (..., channels, n_samples), a tensor or an array, taken to float32 on
    ``device`` (default: where x is; the CPU for an array). Returns
    (..., channels [x 2 with phase], F, T) with ``return_layout='CFT'`` (the
    reference layout) or (..., channels [x 2], T, F) with ``'CTF'`` (the
    order ``fused_infer(input_layout='BCTF')`` takes). The magnitude is
    sqrt(re^2 + im^2), the phase atan2(im, re) in [-pi, pi]."""
    if return_layout not in LAYOUTS:
        raise ValueError(f"return_layout {return_layout!r} not in {LAYOUTS}")
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    frames = stft_frames(x, nperseg, noverlap)
    if cut_last_timeframe:
        frames = frames[..., :-1, :]
    win = hamming_periodic(nperseg, x.device)
    spec = torch.fft.rfft(frames * win, dim=-1) / win.sum()     # (..., C, T, bins)
    if cut_dc:
        spec = spec[..., 1:]
    re, im = spec.real, spec.imag
    if return_layout == "CFT":
        re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    out = torch.sqrt(re * re + im * im)
    if output_phase:
        out = torch.cat([out, torch.atan2(im, re)], dim=-3)
    return out.contiguous()


def spectrum_fast_batch(x, **kwargs) -> torch.Tensor:
    """Batched featurizer: (batch, channels, n_samples) -> (batch, C', F, T)
    (or (batch, C', T, F) with ``return_layout='CTF'``); the keywords are
    :func:`spectrum_fast`'s."""
    x = torch.as_tensor(x)
    if x.ndim != 3:
        raise ValueError(f"spectrum_fast_batch takes (batch, channels, n), got {tuple(x.shape)}")
    return spectrum_fast(x, **kwargs)
