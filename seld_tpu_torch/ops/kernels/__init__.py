"""Hand-written Hopper kernels of the serving, training and predict paths and
of the per-stage profiler, each with its plain PyTorch version beside it.

Every public wrapper takes the plain version for CPU tensors only (the
tests' path); for CUDA tensors it launches its kernel or raises. Each
launch adds one to the wrapper's entry in :data:`launch_counts`, so a run
can show that it went through the kernels.
"""

from __future__ import annotations

import torch

# wrapper name -> launches since the last reset
launch_counts = {
    "stft_mag": 0,
    "stft_mag_fft": 0,   # the float32 FFT kernel's launches, also counted in stft_mag
    "conv3x3_smallcin": 0,
    "conv3x3_widecin": 0,
    "conv3x3_smallcin_wide": 0,
    "conv3x3_im2col": 0,
    "im2col_patches": 0,
    "conv3x3_windows": 0,
    "flash_attn_fwd": 0,
    "flash_attn_bwd": 0,
    "conv_train_stats": 0,
    "conv_train_sel_stats": 0,
    "conv_train_gz": 0,
    "conv_train_dw": 0,
    "ct_train_stats": 0,
    "ct_train_sel_stats": 0,
    "ct_train_gz": 0,
    "ct_train_dw": 0,
    "ct_train_dx": 0,
    "hamilton_matmul": 0,
    "int8_matmul": 0,    # calls: each launches two kernels (the quantize pass, the GEMM)
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The C entry points' dtype code (0 float32, 1 bfloat16)."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return True


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
