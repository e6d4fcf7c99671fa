"""Flash-attention forward (K4): kernel wrapper and plain version.

Counterpart of ``seld_tpu/ops/pallas/attention.py::flash_attention``'s
forward: unmasked softmax(q k^T * scale) v over (B, T, H, D) tensors, plus
the per-row logsumexp (B, H, T) float32 that a backward pass would read.
The kernel is ``csrc/flash_attn_fwd.cu``.
"""

from __future__ import annotations

import torch

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)

HEAD_DIMS = (16, 32, 48, 64, 128)  # head dims the kernel is instantiated for


def _check(q, k, v, self_attention: bool = True) -> None:
    """(B, T, H, D) q, k, v of one dtype; the plain version also takes a
    query length other than the keys' (for query chunks)."""
    same = q.shape == k.shape if self_attention else (
        q.ndim == 4 and q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:])
    if q.ndim != 4 or not same or k.shape != v.shape:
        raise ValueError(
            f"q, k, v must be (B, T, H, D) of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[1] < 1:
        raise ValueError("T must be >= 1")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, as ``seld_tpu/models/attention.py::_attend_full``:
    scores and softmax in float32 (float64 for float64 input), probabilities
    rounded to v's dtype, products accumulated in float32. q may be a chunk
    of the queries: (B, Tq, H, D) against (B, T, H, D) keys and values."""
    _check(q, k, v, self_attention=False)
    cdt = torch.promote_types(q.dtype, torch.float32)
    energy = torch.einsum("nqhd,nkhd->nhqk", q.to(cdt), k.to(cdt)) * scale
    lse = torch.logsumexp(energy, dim=-1)
    attn = torch.softmax(energy, dim=-1).to(v.dtype).to(cdt)
    out = torch.einsum("nhqk,nkhd->nqhd", attn, v.to(cdt)).to(v.dtype)
    return out, lse.to(torch.promote_types(torch.float32, cdt))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, T, H, D) -> (out (B, T, H, D), lse (B, H, T) float32).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    ``seld_flash_attn_fwd`` (D in :data:`HEAD_DIMS`)."""
    _check(q, k, v)
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    require_contiguous(q=q, k=k, v=v)
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"no kernel for head dim {d}; supported: {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y range")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    code = dtype_code(q)
    lib = _build.load()
    err = lib.seld_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, d, float(scale), code, stream_handle(q.device),
    )
    _build.check(err, "seld_flash_attn_fwd")
    launch_counts["flash_attn_fwd"] += 1
    return out, lse
