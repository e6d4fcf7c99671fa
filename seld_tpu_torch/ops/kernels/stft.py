"""STFT magnitude (K1): kernel wrapper and plain version.

Counterpart of ``seld_tpu/ops/pallas/stft.py::stft_mag_pallas`` with
``out_layout='TF'``: x (..., n) audio -> (..., T, nperseg/2) magnitudes with
scipy.signal.stft semantics (periodic Hamming window, zero boundary of
nperseg/2, tail padded to whole hops, 1/sum(win) scaling, DC bin and last
frame dropped). The kernels are in ``csrc/stft_mag.cu``, picked by
:func:`stft_route`: bfloat16 output runs the DFT as a GEMM on the tensor
cores (``seld_stft_mag_tc``: bf16 audio and table, float sums, the JAX
kernel's arithmetic for that output); float32 output at a power-of-two
nperseg (64-2048) a real FFT in float (``seld_stft_mag_fft``: the port of
K1's contract, not of the TPU's DFT GEMM), at any other nperseg % 32 == 0 the
DFT as a SIMT kernel in float (``seld_stft_mag``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)

TC_BINS = 64    # bins per block of the tensor-core kernel (kStBins in stft_mag.cu)
TC_TAPS = 32    # taps per chunk of it (kStK)
TC_FRAMES = 256  # frames per tile of it (kStM)
SMEM_BYTES = 232_448   # shared memory one block may use on the H100
# the tensor-core kernel holds its bin tile's whole bf16 table (k_pad x (2 TC_BINS + 8))
# and two A buffers (TC_FRAMES x (TC_TAPS + 8)) in shared memory
TC_MAX_TAPS = (SMEM_BYTES // 2 - 2 * TC_FRAMES * (TC_TAPS + 8)) // (2 * TC_BINS + 8) \
    // TC_TAPS * TC_TAPS
SIMT_TAPS = 32  # taps per slice of the float32 kernel (kBK)
FFT_NPERSEG = (64, 128, 256, 512, 1024, 2048)   # the FFT kernel's instances

_TABLES: dict[tuple[int, str], torch.Tensor] = {}
_TILES: dict[tuple[int, str], torch.Tensor] = {}
_FFT_TABLES: dict[tuple[int, str, torch.dtype], tuple[torch.Tensor, torch.Tensor]] = {}


def stft_route(nperseg: int, out_dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: 'tc' (bfloat16 output, the tensor-core
    GEMM), 'fft' (float32 output at a power-of-two nperseg of 64-2048) or
    'simt' (float32 output otherwise; nperseg % 32 == 0, else the wrapper
    raises)."""
    if out_dtype == torch.bfloat16:
        return "tc"
    return "fft" if nperseg in FFT_NPERSEG else "simt"


def fft_tables(nperseg: int, device, dtype: torch.dtype = torch.float32
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFT kernel's tables, built in float64 and rounded once to
    ``dtype``: the periodic Hamming window over sum(win), (nperseg,) (the
    same window and scale as :func:`dft_table`), and the twiddles
    e^{-2 pi i q / nperseg}, (nperseg, 2) as [cos, -sin]. Cached per device."""
    device = torch.device(device)
    key = (nperseg, str(device), dtype)
    if key not in _FFT_TABLES:
        q = np.arange(nperseg)
        win = 0.54 - 0.46 * np.cos(2.0 * np.pi * q / nperseg)
        angle = 2.0 * np.pi * q / nperseg
        tw = np.stack([np.cos(angle), -np.sin(angle)], axis=1)
        _FFT_TABLES[key] = (torch.from_numpy(win / win.sum()).to(device, dtype),
                            torch.from_numpy(tw).to(device, dtype).contiguous())
    return _FFT_TABLES[key]


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


def dft_table_tiles(nperseg: int, device) -> torch.Tensor:
    """The bf16 table as the tensor-core kernel reads it: (ceil(nperseg / 2 /
    TC_BINS), k_pad, 2 * TC_BINS) with k_pad = nperseg rounded up to TC_TAPS;
    tile j's row k holds :func:`dft_table`'s cos columns of bins TC_BINS j ..
    TC_BINS j + TC_BINS - 1 at tap k, then their sin columns, zero past
    nperseg and past the last bin. The float32 table rounded to bf16 once,
    as the JAX kernel casts its tables (``stft.py:389``, ``:420``). Cached per
    device."""
    device = torch.device(device)
    key = (nperseg, str(device))
    if key not in _TILES:
        n_bins = nperseg // 2
        n_tiles = -(-n_bins // TC_BINS)
        k_pad = -(-nperseg // TC_TAPS) * TC_TAPS
        table = dft_table(nperseg, device).to(torch.bfloat16)
        halves = [F.pad(table[:, i * n_bins:(i + 1) * n_bins],
                        (0, n_tiles * TC_BINS - n_bins, 0, k_pad - nperseg))
                  .reshape(k_pad, n_tiles, TC_BINS) for i in (0, 1)]   # cos, sin
        _TILES[key] = torch.cat(halves, dim=-1).permute(1, 0, 2).contiguous()
    return _TILES[key]


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
    table, magnitude. For bfloat16 output the frames and the table are
    rounded to bf16 and summed in float32, as the JAX kernel computes that
    output (``stft.py:389``); else it computes in float32 (float64 for
    float64 input)."""
    _check(x, nperseg, noverlap)
    hop, half = nperseg - noverlap, nperseg // 2
    lead, n = x.shape[:-1], x.shape[-1]
    t = n_frames(n, nperseg, noverlap)
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    table = dft_table(nperseg, x.device)
    if out_dtype == torch.bfloat16:
        cdt = torch.float32
        x, table = x.to(torch.bfloat16), table.to(torch.bfloat16)
    right = max(0, (t - 1) * hop + nperseg - half - n)
    xp = F.pad(x.reshape(-1, n).to(cdt), (half, right))
    frames = xp.unfold(-1, nperseg, hop)[:, :t]            # (rows, T, nperseg)
    y = frames @ table.to(cdt)                             # (rows, T, 2 * bins)
    re, im = y[..., : nperseg // 2], y[..., nperseg // 2:]
    mag = torch.sqrt(re * re + im * im)
    return mag.to(out_dtype).reshape(*lead, t, nperseg // 2)


def stft_mag(x: torch.Tensor, nperseg: int = 512, noverlap: int = 112,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., n) float32 or bfloat16 audio -> (..., T, nperseg/2) in
    ``out_dtype``. CPU tensors take :func:`stft_mag_plain`; CUDA tensors
    launch the kernel :func:`stft_route` names: ``seld_stft_mag_tc`` for
    bfloat16 output (any even nperseg whose table fits shared memory: up to
    TC_MAX_TAPS), ``seld_stft_mag_fft`` for float32 output at a power-of-two
    nperseg (64-2048) and ``seld_stft_mag`` for float32 output at any other
    nperseg % 32 == 0."""
    _check(x, nperseg, noverlap)
    if not on_cuda(x):
        return stft_mag_plain(x, nperseg, noverlap, out_dtype)
    require_contiguous(x=x)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels write float32 or bfloat16, not {out_dtype}")
    route = stft_route(nperseg, out_dtype)
    if route == "tc" and -(-nperseg // TC_TAPS) * TC_TAPS > TC_MAX_TAPS:
        raise ValueError(f"the bf16 kernel holds at most {TC_MAX_TAPS} taps of its table "
                         f"in shared memory, got nperseg {nperseg}")
    if route == "simt" and nperseg % SIMT_TAPS:
        raise ValueError(f"the float32 kernel stages {SIMT_TAPS}-tap slices: "
                         f"nperseg % {SIMT_TAPS} != 0 ({nperseg})")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = int(np.prod(lead)) if lead else 1
    if not 0 < rows <= 65535:
        raise ValueError(f"rows {rows} outside the grid's z range")
    t = n_frames(n, nperseg, noverlap)
    out = torch.empty((*lead, t, nperseg // 2), dtype=out_dtype, device=x.device)
    x_code = dtype_code(x)
    lib = _build.load()
    if route == "tc":
        tiles = dft_table_tiles(nperseg, x.device)
        err = lib.seld_stft_mag_tc(x.data_ptr(), tiles.data_ptr(), out.data_ptr(), rows, n, t,
                                   nperseg, nperseg - noverlap, tiles.shape[1], x_code,
                                   stream_handle(x.device))
        _build.check(err, "seld_stft_mag_tc")
    elif route == "fft":
        win, tw = fft_tables(nperseg, x.device)
        err = lib.seld_stft_mag_fft(x.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
                                    rows, n, t, nperseg, nperseg - noverlap, x_code,
                                    stream_handle(x.device))
        _build.check(err, "seld_stft_mag_fft")
        launch_counts["stft_mag_fft"] += 1
    else:
        err = lib.seld_stft_mag(x.data_ptr(), dft_table(nperseg, x.device).data_ptr(),
                                out.data_ptr(), rows, n, t, nperseg, nperseg - noverlap, x_code,
                                stream_handle(x.device))
        _build.check(err, "seld_stft_mag")
    launch_counts["stft_mag"] += 1
    return out
