"""int8 post-training-quantized matmul (K8): kernel wrapper and plain version,
and the per-channel weight quantization done outside the kernel.

Counterpart of ``seld_tpu/ops/pallas/quant.py``: weights are quantized per
output channel (symmetric int8) from the assembled float32 Hamilton weight,
activations per row inside the kernel on every call; products are int8 x int8
summed in int32 and dequantized in the epilogue with the bias. Serving only:
the output carries no gradient. The kernel is ``csrc/int8_matmul.cu``, on
the int8 tensor cores (``mma.sync`` m16n8k32 s8), in two launches: the first
quantizes each row once and writes the weight transposed and zero-padded
along Cin, the second is the GEMM, whose blocks take :func:`row_tile` rows
(64, or 32 where 64-row blocks would not fill the card). The wrapper calls
the op ``seld::int8_matmul`` (``library.py``, CUDA impl
:func:`int8_matmul_cuda`).

The arithmetic is the JAX kernel's as XLA compiles it (``quant.py:41-53``),
bit for bit on the same inputs:

- ``xs = amax * float32(1/127)`` (the source's ``amax / 127``, a division by
  a constant, becomes a multiplication), 1 where a row is all zero;
- ``xq = clamp(round_half_even(x / xs), -127, 127)`` with a true division;
- ``out = fma(float(acc) * xs, w_scale, bias)``, one rounding of the
  epilogue's sum, then the cast to x's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from seld_tpu_torch import _build
from seld_tpu_torch.ops.hamilton import assemble_hamilton
from seld_tpu_torch.ops.kernels import dtype_code, launch_counts, require_cuda, stream_handle

QMAX = 127
INV_QMAX = float(np.float32(1.0 / QMAX))   # float32(1/127), the compiled form's constant
K_STEP = 32          # k of one mma.m16n8k32: Cin is zero-padded to a multiple of it
ROW_TILES = (64, 32)   # rows a GEMM block (kBM), the larger first
PASS_COLS = 128      # output columns of a GEMM block (kBN)
SMEM_BYTES = 232_448   # shared memory one block may use on the H100
_W_CHUNK_BYTES = 2 * 128 * 144   # the kernel's weight buffers: 2 of 128 x (128 + 16) bytes


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (Cin, Cout) -> (int8 (Cin, Cout),
    float32 scale (Cout,)), w ~= int8 * scale (``amax / 127``, a true division,
    as the JAX package computes it outside its kernel)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_hamilton(comps: torch.Tensor, linear_table: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """comps (n, Cin/n, Cout/n) -> (int8 assembled (Cin, Cout), float32 scales
    (Cout,)): the Hamilton weight assembled from the float32 components in
    the conv (``linear_table=False``) or linear orientation, then quantized."""
    return quantize_weight_per_channel(assemble_hamilton(comps.detach().float(), linear_table))


def _check(x, w_q, w_scale, bias):
    if x.ndim < 1 or w_q.ndim != 2 or x.shape[-1] != w_q.shape[0]:
        raise ValueError(f"x (..., Cin) and w_q (Cin, Cout) do not fit: {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    cout = w_q.shape[1]
    if tuple(w_scale.shape) != (cout,) or (bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError(f"w_scale and bias must be ({cout},)")


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic quantization of x2 (M, Cin): (xq float32 holding the
    int8 values, xs (M, 1) float32)."""
    xf = x2.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    xs = torch.where(amax > 0, amax * torch.tensor(INV_QMAX, dtype=torch.float32,
                                                   device=x2.device), torch.ones_like(amax))
    return torch.clamp(torch.round(xf / xs), -QMAX, QMAX), xs


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: quantize the rows; the int32 sum as a float64 matmul
    (exact: |acc| <= Cin * 127^2 < 2^53); ``acc * xs`` in float32; the
    epilogue ``acc_xs * w_scale + bias`` in float64, rounded once to float32
    (an fma's single rounding), then to x's dtype."""
    _check(x, w_q, w_scale, bias)
    x = x.detach()
    lead, cin, cout = x.shape[:-1], x.shape[-1], w_q.shape[1]
    xq, xs = quantize_rows(x.reshape(-1, cin))
    acc = (xq.double() @ w_q.double()).float()
    a = acc * xs
    b = torch.zeros(cout, dtype=torch.float64, device=x.device) if bias is None else \
        bias.detach().float().double()
    out = (a.double() * w_scale.detach().float().double() + b).float()
    return out.to(x.dtype).reshape(*lead, cout)


def padded_k(cin: int) -> int:
    """Cin rounded up to the kernel's k step (32)."""
    return -(-cin // K_STEP) * K_STEP


def smem_bytes(bm: int, cin: int) -> int:
    """Shared memory of one GEMM block (``mm_smem_bytes`` in the kernel): the
    row scales, the int8 tile (rows of padded_k(Cin) + 16 bytes) and the
    weight ring."""
    return -(-bm * 4 // 16) * 16 + bm * (padded_k(cin) + 16) + _W_CHUNK_BYTES


def row_tile(m: int, cin: int, cout: int, sms: int) -> int:
    """Rows a GEMM block: the first of :data:`ROW_TILES` whose shared memory
    fits (64 up to Cin 3008, then 32 up to 6080), and the last that fits
    where the larger tile's blocks would not fill the card's ``sms`` SMs
    (32-row blocks ran faster at M 600 and 1200 and slower at 4800 and 9600,
    Cin = Cout = 384, on the H100: PERF.md §6). The grid is ceil(M / tile)
    row tiles x ceil(Cout / 128) column passes; row tile i takes rows
    [i * tile, (i + 1) * tile)."""
    fits = [bm for bm in ROW_TILES if smem_bytes(bm, cin) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"int8_matmul: Cin {cin} needs more shared memory than a block has")
    blocks = -(-m // fits[0]) * -(-cout // PASS_COLS)
    return fits[0] if blocks >= sms else fits[-1]


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., Cin) float32 or bfloat16 @ dequant(w_q int8 (Cin, Cout),
    w_scale (Cout,)) + bias -> (..., Cout) in x's dtype, with the rows of x
    quantized to int8 on the fly. The rows go flat through the op
    ``seld::int8_matmul``, detached (the output carries no gradient): CPU
    tensors take :func:`int8_matmul_plain`, CUDA tensors
    :func:`int8_matmul_cuda`, two kernels that count as one in
    ``launch_counts['int8_matmul']``."""
    _check(x, w_q, w_scale, bias)
    lead, cin, cout = x.shape[:-1], x.shape[-1], w_q.shape[1]
    out = torch.ops.seld.int8_matmul(x.detach().reshape(-1, cin), w_q, w_scale.detach(),
                                     None if bias is None else bias.detach())
    return out.reshape(*lead, cout)


def int8_matmul_cuda(x2: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA impl of ``seld::int8_matmul`` on x2 (M, Cin): launches
    ``seld_int8_matmul`` with GEMM blocks of :func:`row_tile` rows, or
    raises."""
    _check(x2, w_q, w_scale, bias)
    require_cuda(*((x2, w_q, w_scale) if bias is None else (x2, w_q, w_scale, bias)))
    if x2.ndim != 2:
        raise ValueError(f"x must be (M, Cin), got {tuple(x2.shape)}")
    (m, cin), cout = x2.shape, w_q.shape[1]
    x2 = x2.contiguous()
    ws = w_scale.float().contiguous()
    # the bias as it comes (the layers round it to x's dtype), float32 otherwise
    if bias is not None:
        bias = (bias if bias.dtype in (torch.float32, torch.bfloat16) else bias.float()).contiguous()
    out = torch.empty((m, cout), dtype=x2.dtype, device=x2.device)
    if m:
        sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
        bm = row_tile(m, cin, cout, sms)
        k_pad = padded_k(cin)
        w_q = w_q.contiguous()
        # scratch of the first launch: the weight as (Cout, k_pad), the int8 rows and their scales
        w_t = torch.empty((cout, k_pad), dtype=torch.int8, device=x2.device)
        xq = torch.empty((m, k_pad), dtype=torch.int8, device=x2.device)
        xs = torch.empty(m, dtype=torch.float32, device=x2.device)
        lib = _build.load()
        err = lib.seld_int8_matmul(
            x2.data_ptr(), w_q.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), xq.data_ptr(),
            xs.data_ptr(), m, cin, k_pad, cout, bm, dtype_code(x2),
            -1 if bias is None else dtype_code(bias), stream_handle(x2.device))
        _build.check(err, "seld_int8_matmul")
        launch_counts["int8_matmul"] += 1   # one call: the quantize launch and the GEMM
    return out
