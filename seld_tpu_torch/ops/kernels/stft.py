"""STFT magnitude (K1): kernel wrapper and plain version.

Counterpart of ``seld_tpu/ops/pallas/stft.py::stft_mag_pallas`` with
``out_layout='TF'``: x (..., n) audio -> (..., T, nperseg/2) magnitudes with
scipy.signal.stft semantics (periodic Hamming window, zero boundary of
nperseg/2, tail padded to whole hops, 1/sum(win) scaling, DC bin and last
frame dropped). The kernel is ``csrc/stft_mag.cu``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)

_TABLES: dict[tuple[int, str], torch.Tensor] = {}


def dft_table(nperseg: int, device) -> torch.Tensor:
    """(nperseg, nperseg) float32 windowed real-DFT table, columns
    [cos of bins 1..nperseg/2 | sin of bins 1..nperseg/2], with the periodic
    Hamming window and 1/sum(win) folded in (built in float64, as
    ``seld_tpu/ops/pallas/stft.py::_shifted_dft_tables``). Cached per device."""
    device = torch.device(device)
    key = (nperseg, str(device))
    if key not in _TABLES:
        n_bins = nperseg // 2
        win = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
        t = np.arange(nperseg)[:, None]
        k = np.arange(1, n_bins + 1)[None, :]
        angle = 2.0 * np.pi * t * k / nperseg
        scale = win[:, None] / win.sum()
        m = np.concatenate([np.cos(angle) * scale, np.sin(angle) * scale], axis=1)
        _TABLES[key] = torch.from_numpy(m.astype(np.float32)).to(device)
    return _TABLES[key]


def n_frames(n: int, nperseg: int, noverlap: int) -> int:
    """scipy's frame count for n samples, last frame already cut."""
    hop = nperseg - noverlap
    n2 = n + 2 * (nperseg // 2)
    rem = (-(n2 - nperseg)) % hop
    return (n2 + rem - nperseg) // hop


def _check(x: torch.Tensor, nperseg: int, noverlap: int) -> None:
    hop = nperseg - noverlap
    if hop <= 0 or nperseg % 2:
        raise ValueError(f"need an even nperseg and hop > 0, got {nperseg}/{noverlap}")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (..., n) audio, got {tuple(x.shape)}")


def stft_mag_plain(x: torch.Tensor, nperseg: int = 512, noverlap: int = 112,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: zero pad, unfold into frames, one matmul with the
    table, magnitude. Computes in float32 (float64 for float64 input)."""
    _check(x, nperseg, noverlap)
    hop, half = nperseg - noverlap, nperseg // 2
    lead, n = x.shape[:-1], x.shape[-1]
    t = n_frames(n, nperseg, noverlap)
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    right = max(0, (t - 1) * hop + nperseg - half - n)
    xp = F.pad(x.reshape(-1, n).to(cdt), (half, right))
    frames = xp.unfold(-1, nperseg, hop)[:, :t]            # (rows, T, nperseg)
    y = frames @ dft_table(nperseg, x.device).to(cdt)      # (rows, T, 2 * bins)
    re, im = y[..., : nperseg // 2], y[..., nperseg // 2:]
    mag = torch.sqrt(re * re + im * im)
    return mag.to(out_dtype).reshape(*lead, t, nperseg // 2)


def stft_mag(x: torch.Tensor, nperseg: int = 512, noverlap: int = 112,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., n) float32 or bfloat16 audio -> (..., T, nperseg/2) in
    ``out_dtype``. CPU tensors take :func:`stft_mag_plain`; CUDA tensors
    launch ``seld_stft_mag``."""
    _check(x, nperseg, noverlap)
    if not on_cuda(x):
        return stft_mag_plain(x, nperseg, noverlap, out_dtype)
    require_contiguous(x=x)
    if nperseg % 32:
        raise ValueError(f"the kernel stages 32-tap slices: nperseg % 32 != 0 ({nperseg})")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = int(np.prod(lead)) if lead else 1
    if not 0 < rows <= 65535:
        raise ValueError(f"rows {rows} outside the grid's z range")
    t = n_frames(n, nperseg, noverlap)
    out = torch.empty((*lead, t, nperseg // 2), dtype=out_dtype, device=x.device)
    x_code = dtype_code(x)
    o_code = dtype_code(out)
    table = dft_table(nperseg, x.device)
    lib = _build.load()
    err = lib.seld_stft_mag(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), rows, n, t, nperseg,
        nperseg - noverlap, x_code, o_code, stream_handle(x.device),
    )
    _build.check(err, "seld_stft_mag")
    launch_counts["stft_mag"] += 1
    return out
