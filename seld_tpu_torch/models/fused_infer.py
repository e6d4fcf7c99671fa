"""Fused serving forward: kernel CNN front-end, restructured TCN, direct heads.

Counterpart of ``seld_tpu/models/fused_infer.py::fused_infer``. It runs an
eval-mode :class:`SELDModel` from its own parameters, in
``model.compute_dtype``, one trunk or two (2Parallel / ``parallel_magphase``:
the features split on the channel axis as ``SELDModel.split_channels`` does,
each trunk's front end and TCN run from its own modules, their outputs
concatenated on the feature axis before the heads):

- every CNN stage runs a fused conv + folded BN + ReLU + frequency-pool
  kernel (``ops/kernels/conv2d_pool.py::conv2d_bn_relu_fpool``), in float32
  and in bfloat16, chosen per stage as the JAX package chooses it: K2 (the
  thin pack) for Cin <= 8 under ``smallcin_impl='thin'``, else K2w (the wide
  pack) for 3 * Cin <= 32, else K3 for Cin % 8 == 0, else K10b (per-tap
  windows, any Cin; the JAX package runs an XLA conv there); the stages stay
  in (B, C, F, T) between kernels and the flatten to the TCN's channel-major
  (B, C * F', T) is a reshape; with ``use_se_block`` the SE epilogue scales
  each stage's output (``_apply_se``: the squeeze in float32, the scale cast
  to the stage's dtype);
- per ResBlock, eval BN is folded into affines and conv weights, the filter
  and gate dilated convs are merged into one L -> 2G conv, and the skip and
  res 1x1 convs into one G -> (U + L) matmul;
- the tail runs conv1, the K4 flash-attention kernel, conv2 and the pools;
- the heads run in float32 with sigmoid (SED) and tanh (DOA), as plain
  matmuls whatever the model's ``qconv_impl`` (the JAX package's heads call
  the plain ops too): neither K7 nor K8 is on this path.

BN and any conv bias fold as ``inv = scale / sqrt(var + eps)``,
``bias' = bn_bias - mean * inv (+ conv_b * inv)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch.models.blocks import ConvTCBlock, ResBlock
from seld_tpu_torch.models.layers import BatchNorm, SEBlock
from seld_tpu_torch.models.seld import SELDModel
from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_bn_relu_fpool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def folded_affine(bn: BatchNorm, conv) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) float32 of BN folded over a conv's output (and its bias)."""
    inv, shift = bn.affine()
    if conv.b is not None:
        shift = shift + conv.b * inv
    return inv.float(), shift.float()


def _apply_se(se: SEBlock, h: torch.Tensor) -> torch.Tensor:
    """Eval SE epilogue on a stage output h (B, C, F, T)
    (``seld_tpu/models/fused_infer.py::_apply_se``): the squeeze in float32,
    the per-(batch, channel) scale cast to h's dtype."""
    s = se.excite(h.float().mean((2, 3)))
    return h * s[:, :, None, None].to(h.dtype)


def _frontend(trunk: ConvTCBlock, x: torch.Tensor, dtype: torch.dtype,
              smallcin_impl: str) -> torch.Tensor:
    """One trunk's CNN stages on x (B, C, F, T) -> channel-major (B, C' * F', T)."""
    h = x.to(dtype).contiguous()
    for i in range(trunk.n_stages):
        pf = trunk.pools[i][0]
        conv, bn = getattr(trunk, f"cnn_{i}"), getattr(trunk, f"cnn_bn_{i}")
        w = conv.dense_kernel().to(dtype).contiguous()    # (3, 3, Cin, Cout)
        scale, bias = folded_affine(bn, conv)
        h = conv2d_bn_relu_fpool(h, w, scale, bias, pf, smallcin_impl=smallcin_impl)
        if trunk.use_se_block:
            h = _apply_se(getattr(trunk, f"se_{i}"), h)
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


def _tcn(trunk: ConvTCBlock, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One trunk's eval TCN on channel-major (B, L, T) -> (B, T_pooled, V[-1])."""
    tcn = trunk.tcn
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
                featurize=None, smallcin_impl: str = "thin") -> tuple[torch.Tensor, torch.Tensor]:
    """(sed, doa) float32 for an eval-mode SELDModel, one trunk or two.

    x: (B, C, F, T) features as ``model(x)`` takes them, or (B, C, T, F) with
    ``input_layout='BCTF'`` (the STFT kernel's native order). With
    ``featurize`` given, x is raw audio and ``featurize(x)`` yields those
    features. ``smallcin_impl`` ('thin' or 'wide', ``bench.py --smallcin``)
    picks the pack of the stages with Cin <= 8: K2 or K2w ('wide' is there
    for parity with the JAX package; 'thin' is the faster one); the stage
    router (``frontend_stage_kernel``) raises on any other value."""
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
        h = torch.cat([_tcn(trunk, _frontend(trunk, part, dtype, smallcin_impl), dtype).float()
                       for trunk, part in zip(model.trunks, model.split_channels(feats))],
                      dim=-1)
        sed = torch.sigmoid(model.head(h, "sed", qconv_impl="xla"))
        doa = torch.tanh(model.head(h, "doa", qconv_impl="xla"))
    return sed, doa
