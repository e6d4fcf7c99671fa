"""Fused serving forward: kernel CNN front-end, restructured TCN, direct heads.

Counterpart of ``seld_tpu/models/fused_infer.py::fused_infer`` for the
single-trunk models. It runs an eval-mode :class:`SELDModel` from its own
parameters, in ``model.compute_dtype``:

- every CNN stage runs the fused conv + folded BN + ReLU + frequency-pool
  kernel (``ops/kernels/conv2d_pool.py``: K2 for Cin <= 8, K3 for
  Cin % 8 == 0; every shipped config's stages are 3x3 with such Cin and an F
  that divides by the pool, and the wrapper rejects anything else), in
  float32 and in bfloat16; the stages stay in (B, C, F, T) between kernels
  and the flatten to the TCN's channel-major (B, C * F', T) is a reshape;
- per ResBlock, eval BN is folded into affines and conv weights, the filter
  and gate dilated convs are merged into one L -> 2G conv, and the skip and
  res 1x1 convs into one G -> (U + L) matmul;
- the tail runs conv1, the K4 flash-attention kernel, conv2 and the pools;
- the heads run in float32 with sigmoid (SED) and tanh (DOA).

BN and any conv bias fold as ``inv = scale / sqrt(var + eps)``,
``bias' = bn_bias - mean * inv (+ conv_b * inv)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch.models.blocks import ResBlock
from seld_tpu_torch.models.layers import BatchNorm
from seld_tpu_torch.models.seld import SELDModel
from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_bn_relu_fpool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def folded_affine(bn: BatchNorm, conv) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) float32 of BN folded over a conv's output (and its bias)."""
    inv, shift = bn.affine()
    if conv.b is not None:
        shift = shift + conv.b * inv
    return inv.float(), shift.float()


def _frontend(model: SELDModel, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """CNN stages on x (B, C, F, T) -> channel-major (B, C' * F', T)."""
    trunk = model.seld_block
    h = x.to(dtype).contiguous()
    for i in range(trunk.n_stages):
        pf = trunk.pools[i][0]
        conv, bn = getattr(trunk, f"cnn_{i}"), getattr(trunk, f"cnn_bn_{i}")
        w = conv.dense_kernel().to(dtype).contiguous()    # (3, 3, Cin, Cout)
        scale, bias = folded_affine(bn, conv)
        h = conv2d_bn_relu_fpool(h, w, scale, bias, pf)
    b, c, f, t = h.shape
    return h.reshape(b, c * f, t)


def _resblock(blk: ResBlock, h: torch.Tensor, dtype: torch.dtype):
    """One ResBlock on channels-first (B, L, T): returns (h', skip)."""
    inv, shift = blk.bn_pre.affine()
    hpre = torch.tanh(h * inv.to(dtype)[:, None] + shift.to(dtype)[:, None])
    ws, bs = [], []
    for conv, bn in ((blk.conv_filter, blk.bn_filter), (blk.conv_gate, blk.bn_gate)):
        scale, bias = folded_affine(bn, conv)
        ws.append(conv.dense_kernel() * scale)           # (k, L, G) scaled per out channel
        bs.append(bias)
    w_fg = torch.cat(ws, dim=-1).permute(2, 1, 0).to(dtype)   # (2G, L, k)
    y = F.conv1d(hpre, w_fg, torch.cat(bs).to(dtype), padding=blk.padding,
                 dilation=blk.dilation)
    g = y.shape[1] // 2
    y = torch.tanh(y[:, :g]) * torch.sigmoid(y[:, g:])
    w_skip, w_res = blk.conv_skip.dense_kernel()[0], blk.conv_res.dense_kernel()[0]
    w_sr = torch.cat([w_skip, w_res], dim=-1).t().to(dtype)    # (U + L, G)
    z = torch.matmul(w_sr, y)
    if blk.conv_skip.b is not None:
        z = z + torch.cat([blk.conv_skip.b, blk.conv_res.b]).to(dtype)[:, None]
    u = w_skip.shape[-1]
    return hpre + z[:, u:], z[:, :u]


def _tcn(model: SELDModel, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Eval TCN on channel-major (B, L, T) -> (B, T_pooled, V[-1])."""
    tcn = model.seld_block.tcn
    skip_sum = None
    for idx in range(tcn.n_blocks):
        h, skip = _resblock(getattr(tcn, f"resblock_{idx}"), h, dtype)
        skip_sum = skip if skip_sum is None else skip_sum + skip
    out = torch.relu(skip_sum).transpose(1, 2)          # (B, T, U)
    out = tcn._pool(out, 0)
    out = tcn.conv1(out)
    out = tcn.attention(out, out, out, impl="flash")
    out = tcn._pool(torch.relu(out), 1)
    out = tcn.conv2(out)
    return tcn._pool(torch.tanh(out), 2)


def fused_infer(model: SELDModel, x: torch.Tensor, input_layout: str = "BCFT",
                featurize=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sed, doa) float32 for an eval-mode single-trunk SELDModel.

    x: (B, C, F, T) features as ``model(x)`` takes them, or (B, C, T, F) with
    ``input_layout='BCTF'`` (the STFT kernel's native order). With
    ``featurize`` given, x is raw audio and ``featurize(x)`` yields those
    features."""
    if input_layout not in ("BCFT", "BCTF"):
        raise ValueError(f"input_layout {input_layout!r}")
    if model.pool_time != "TCN":
        raise ValueError("the fused front-end pools frequency only (pool_time='TCN')")
    if model.batch_norm != "BN":
        raise ValueError("fused_infer folds eval BN into the convs; other configs serve "
                         "through model(x)")
    dtype = _DTYPES[model.compute_dtype]
    with torch.no_grad():
        feats = featurize(x) if featurize is not None else x
        if input_layout == "BCTF":
            feats = feats.transpose(2, 3)
        h = _tcn(model, _frontend(model, feats, dtype), dtype).float()
        sed = torch.sigmoid(model.head(h, "sed"))
        doa = torch.tanh(model.head(h, "doa"))
    return sed, doa
