"""Flash attention: the forward (K4) and backward (K6) kernel wrappers, their
plain versions, and the autograd Function that joins them.

Counterpart of ``seld_tpu/ops/pallas/attention.py::flash_attention``:
unmasked softmax(q k^T * scale) v over (B, T, H, D) tensors. The forward
also returns the per-row logsumexp (B, H, T) float32, which the backward
reads to recompute the probabilities (FlashAttention-2). The kernels are
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``; the forward is
reached through the op ``seld::flash_attn_fwd`` (``library.py``, CUDA impl
:func:`flash_attention_cuda`), the backward through its wrapper.
"""

from __future__ import annotations

import torch

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, require_cuda, stream_handle,
)

HEAD_DIMS = (16, 32, 48, 64, 128)  # head dims the kernels are instantiated for
WIDE_STEP = 32    # past 128: D padded to a multiple of this
WIDE_GROUPS = (160, 192, 224, 256)   # column-group widths the wide kernels are built for


def head_dim_plan(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(d_pad, group width) a head dim ``d`` runs at: the padded D, and the
    width of the output column groups, ceil(d_pad / width) of them (grid z),
    the last narrower where the width does not divide d_pad; each group's
    block computes S over all of d_pad, once per key tile. The kernels'
    dispatch derives the same groups from these two numbers.

    - D <= 128: the least of :data:`HEAD_DIMS` >= d, one group.
    - Past 128, in both dtypes: d padded to the next multiple of
      :data:`WIDE_STEP` (a D that is one needs no pad copy), in ceil(d_pad /
      256) groups whose width, one of :data:`WIDE_GROUPS`, is d_pad over the
      groups rounded up to a multiple of 32. float32 keeps bfloat16's widths
      (its wide kernels, in split TF32, are built for the same ones): its
      tiles take twice the bytes, which the kernels meet by streaming K (and
      the backward's operands) in chunks of D, not by narrower groups, so S
      is still computed once per group. The JAX kernel pads D to a multiple
      of 128 (``seld_tpu/ops/pallas/attention.py:155-158``), a TPU lane rule.
    """
    del dtype   # one plan for both dtypes
    for hd in HEAD_DIMS:
        if hd >= d:
            return hd, hd
    d_pad = -(-d // WIDE_STEP) * WIDE_STEP
    groups = -(-d_pad // WIDE_GROUPS[-1])
    return d_pad, -(-d_pad // (groups * WIDE_STEP)) * WIDE_STEP


def pad_heads(d_pad: int, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(B, T, H, D) tensors zero-padded along D to ``d_pad`` (contiguous; the
    tensors themselves where D == d_pad). The caller keeps the scale of the
    true D: zero columns of q and k add nothing to a score, zero columns of
    v give output columns (and gradient columns) that are sliced off, and
    the logsumexp is unchanged, so out[..., :D] and the sliced gradients are
    the unpadded attention's (the JAX kernel pads D to 128 the same way)."""
    return tuple(t if t.shape[-1] == d_pad else
                 torch.nn.functional.pad(t, (0, d_pad - t.shape[-1])).contiguous()
                 for t in tensors)


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
    """q, k, v (B, T, H, D) -> (out (B, T, H, D), lse (B, H, T) float32),
    through the op ``seld::flash_attn_fwd``: CPU tensors take
    :func:`flash_attention_plain`, CUDA tensors
    :func:`flash_attention_cuda`."""
    _check(q, k, v)
    return torch.ops.seld.flash_attn_fwd(q, k, v, scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA impl of ``seld::flash_attn_fwd``: launches
    ``seld_flash_attn_fwd`` at the padded D of :func:`head_dim_plan` on
    zero-padded q, k, v (:func:`pad_heads`; no copy where D is already it),
    one block per column group and query tile, out sliced back to D (a
    copy: out never shares storage with q), or raises. Past head dim 128
    that is the wide kernel of the dtype: bfloat16's on ``mma.sync``,
    float32's in split TF32 (``flash_fwd_wide_tf32_kernel``)."""
    _check(q, k, v)
    require_cuda(q, k, v)
    require_contiguous(q=q, k=k, v=v)
    b, t, h, d_true = q.shape
    d, group = head_dim_plan(d_true, q.dtype)
    q, k, v = pad_heads(d, q, k, v)
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y range")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    code = dtype_code(q)
    lib = _build.load()
    err = lib.seld_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, d, group, float(scale), code, stream_handle(q.device),
    )
    _build.check(err, "seld_flash_attn_fwd")
    launch_counts["flash_attn_fwd"] += 1
    if d != d_true:
        out = out[..., :d_true].contiguous()
    return out, lse


def flash_attention_bwd_plain(q, k, v, out, dout, lse, scale: float):
    """Plain backward from the forward's lse: P = exp(q k^T * scale - lse),
    delta = rowsum(dout * out), dS = P * (dout v^T - delta); returns
    (dq = dS k * scale, dk = dS^T q * scale, dv = P^T dout) in q's dtype,
    computed in float32 (float64 for float64 input)."""
    _check(q, k, v)
    cdt = torch.promote_types(q.dtype, torch.float32)
    q_, k_, v_, o_, do_ = (t.to(cdt) for t in (q, k, v, out, dout))
    p = torch.exp(torch.einsum("nqhd,nkhd->nhqk", q_, k_) * scale - lse.to(cdt)[..., None])
    dv = torch.einsum("nhqk,nqhd->nkhd", p, do_)
    delta = (do_ * o_).sum(-1).transpose(1, 2)                       # (B, H, T)
    ds = p * (torch.einsum("nqhd,nkhd->nhqk", do_, v_) - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k_) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q_) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, dout, lse, scale: float):
    """q, k, v, out, dout (B, T, H, D) of one dtype, lse (B, H, T) float32 ->
    (dq, dk, dv). CPU tensors take :func:`flash_attention_bwd_plain`; CUDA
    tensors launch ``seld_flash_attn_bwd`` (delta, dq and dk/dv passes) at
    the padded D and column groups of :func:`head_dim_plan`, on zero-padded
    operands where D is not the padded one, the gradients sliced back to D;
    past head dim 128 the dtype's wide passes (float32's in split TF32:
    ``flash_dq_wide_tf32_kernel``, ``flash_dkv_wide_tf32_kernel``)."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"{tuple(q.shape)}")
    b, t, h, d = q.shape
    if tuple(lse.shape) != (b, h, t):
        raise ValueError(f"lse must be {(b, h, t)}, got {tuple(lse.shape)}")
    if not on_cuda(q, k, v, out, dout, lse):
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, scale)
    require_contiguous(q=q, k=k, v=v, out=out, dout=dout, lse=lse)
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"out / dout must be {q.dtype} and lse float32, got "
                        f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    d_true, (d, group) = d, head_dim_plan(d, q.dtype)
    q, k, v, out, dout = pad_heads(d, q, k, v, out, dout)
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y range")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.seld_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, d, group, float(scale), dtype_code(q), stream_handle(q.device),
    )
    _build.check(err, "seld_flash_attn_bwd")
    launch_counts["flash_attn_bwd"] += 1
    if d != d_true:
        dq, dk, dv = (g[..., :d_true].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """Forward :func:`flash_attention`, saving (q, k, v, out, lse); backward
    :func:`flash_attention_bwd` with the cotangent in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, g.to(q.dtype).contiguous(), lse,
                                         ctx.scale)
        return dq, dk, dv, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Differentiable flash attention: (B, T, H, D) q, k, v -> out; K4 forward,
    K6 backward on CUDA tensors, the plain versions on CPU tensors."""
    return _FlashAttentionFn.apply(q, k, v, scale)
