"""SELD-TCN building blocks: gated ResBlock, TC block, CNN front-end.

Counterpart of ``seld_tpu/models/blocks.py`` (one trunk's forward). The TCN
works on channel-last ``(B, T, L)``, the CNN front-end on ``(B, F, T, C)``.
Two reference quirks are kept: the residual is added to the pre-activated
``h`` (``tanh(bn_pre(x))``), not to the block input; and the CNN output is
flattened channel-major, so TCN feature ``c * F' + f`` is channel c at
frequency f.

``forward(x, train=False, generator=None)``: train mode normalizes with batch
statistics (updating the running ones), applies the spatial dropout after
each ResBlock's gate and the dropout after each CNN stage, drawing from
``generator``. In train mode CNN stage 0 may run the K5 kernels
(``ops/kernels/conv2d_train.py``), as ``ConvTCBlock._fused_train_ok`` decides;
with ``frontend_impl='ct'`` every CNN stage runs a kernel op in the (B, C, F,
T) layout, K5 for stage 0 and K9 (``ops/kernels/conv2d_ct_train.py``) for
the stages after it (``ConvTCBlock._ct_train_ok``); neither kernel route takes
a trunk with the SE block, which trains on the plain stages, as the JAX
package's does. ``cross_rank`` (``parallel/cross_rank.py``), under data
parallelism, reaches every train-mode BatchNorm, K5, K9 and dropout of the
trunk: their batch statistics are the global batch's, their masks its rows.
``qconv_impl`` ('xla',
'pallas', 'int8') reaches every conv, as in the JAX package; only the
pointwise ones (each ResBlock's skip and res) take it (``layers.py``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from seld_tpu_torch.models.attention import MultiHeadAttention
from seld_tpu_torch.models.layers import (
    BN_EPS, BatchNorm, Dropout, SEBlock, SpatialDropout1D, make_conv, max_pool_2d,
    max_pool_time,
)
from seld_tpu_torch.ops.kernels import conv2d_ct_train, conv2d_train

BN_ON_TCN = {"BN", "BN_on_TCN", "BNonTCN"}
BN_ON_CNN = {"BN", "BN_on_CNN", "BNonCNN"}
# train-mode CNN stage 0: 'auto' takes the K5 kernels on a CUDA tensor when
# the structural conditions hold; 'xla' (the JAX package's name) the plain
# stage; 'fused' the K5 op whatever the device (its plain versions on the CPU),
# raising on a CUDA tensor whose stage 0 the op cannot take; 'ct' (opt-in, the
# JAX package's 'pallas-ct') the K5 op for stage 0 and the K9 op for every
# later stage, with the same rule for a CUDA tensor
FRONTEND_IMPLS = ("auto", "xla", "fused", "ct")


def dilation_schedule(D: Sequence, mode: str) -> List[int]:
    """Per-resblock dilations: explicit lists, or counts expanded with the
    fibonacci (1, 1, 2, 3, 5, ...) or exponential (2**d) rule."""
    out: List[int] = []
    for n_resblock in D:
        if isinstance(n_resblock, (list, tuple)):
            out.extend(int(d) for d in n_resblock)
            continue
        prev1, prev2 = 1, 0
        for d in range(int(n_resblock)):
            if mode == "fibonacci":
                dil = 1 if d == 0 else prev1 + prev2
                if d:
                    prev2, prev1 = prev1, dil
            else:
                dil = 2 ** d
            out.append(dil)
    return out


def receptive_field(D: Sequence, kernel_size: int, dilation_mode: str):
    """(1 + sum((k - 1) * dilation), number of resblocks)."""
    dils = dilation_schedule(D, dilation_mode)
    return 1 + (kernel_size - 1) * int(np.sum(dils)), len(dils)


class ResBlock(nn.Module):
    """Gated pre-activation residual block on (B, T, L): returns
    (h + res, skip) with h = tanh(bn_pre(x)) when BN is on the TCN, else x;
    spatial dropout on the gated output in train mode."""

    def __init__(self, domain: str, in_features: int, G: int, U: int, kernel_size: int = 3,
                 dilation: int = 1, use_bias: bool = True, batch_norm: str = "BN",
                 spatial_dropout_rate: float = 0.5, *, qconv_impl: str = "xla", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        L = in_features
        self.use_bn = batch_norm in BN_ON_TCN
        self.dilation = dilation
        self.padding = ((kernel_size - 1) * dilation) // 2
        conv = dict(use_bias=use_bias, impl=qconv_impl, device=device, generator=generator)
        if self.use_bn:
            self.bn_pre = BatchNorm(L, device=device)
        self.conv_filter = make_conv(domain, L, G, kernel_size, 1, padding=self.padding,
                                     dilation=dilation, **conv)
        self.conv_gate = make_conv(domain, L, G, kernel_size, 1, padding=self.padding,
                                   dilation=dilation, **conv)
        if self.use_bn:
            self.bn_filter = BatchNorm(G, device=device)
            self.bn_gate = BatchNorm(G, device=device)
        self.conv_skip = make_conv(domain, G, U, 1, 1, **conv)
        self.conv_res = make_conv(domain, G, L, 1, 1, **conv)
        self.spatial_dropout = SpatialDropout1D(spatial_dropout_rate)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        h = torch.tanh(self.bn_pre(x, train, cross_rank)) if self.use_bn else x
        y_f, y_g = self.conv_filter(h), self.conv_gate(h)
        if self.use_bn:
            y_f, y_g = self.bn_filter(y_f, train, cross_rank), self.bn_gate(y_g, train, cross_rank)
        y = self.spatial_dropout(torch.tanh(y_f) * torch.sigmoid(y_g), train, generator,
                                 cross_rank)
        return h + self.conv_res(y), self.conv_skip(y)


class TCBlock(nn.Module):
    """Dilated TCN stack, then relu -> pool -> conv1 -> MHA(8 heads) -> relu ->
    pool -> conv2 -> tanh -> pool on (B, T, L) (time pools only when
    pool_time == 'TCN')."""

    def __init__(self, domain: str, in_features: int, G: int, U: int, V: Sequence[int],
                 V_kernel_size: int, pool_size, D, dilation_mode: str, pool_time: str,
                 batch_norm: str, kernel_size_dilated_conv: int, attention_impl: str,
                 use_bias: bool, spatial_dropout_rate: float = 0.5, *, qconv_impl: str = "xla",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool_size, self.pool_time = pool_size, pool_time
        self.n_blocks = 0
        for idx, dil in enumerate(dilation_schedule(D, dilation_mode)):
            setattr(self, f"resblock_{idx}", ResBlock(
                domain, in_features, G, U, kernel_size_dilated_conv, dil, use_bias,
                batch_norm, spatial_dropout_rate, qconv_impl=qconv_impl, device=device,
                generator=generator))
            self.n_blocks += 1
        kw = dict(padding=1, use_bias=use_bias, impl=qconv_impl, device=device,
                  generator=generator)
        self.conv1 = make_conv(domain, U, V[0], V_kernel_size, 1, **kw)
        self.attention = MultiHeadAttention(V[0], 8, attention_impl, device=device,
                                            generator=generator)
        self.conv2 = make_conv(domain, V[0], V[1], V_kernel_size, 1, **kw)

    def _pool(self, x, i):
        return max_pool_time(x, int(self.pool_size[i][1])) if self.pool_time == "TCN" else x

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        skip_sum = None
        for idx in range(self.n_blocks):
            x, skip = getattr(self, f"resblock_{idx}")(x, train, generator, cross_rank)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        out = self.conv1(self._pool(torch.relu(skip_sum), 0))
        out = self.attention(out, out, out)
        out = self.conv2(self._pool(torch.relu(out), 1))
        return self._pool(torch.tanh(out), 2)


class ConvTCBlock(nn.Module):
    """CNN front-end + TCN on (B, F, T, C) -> (B, T_pooled, V[-1]): per stage
    conv2d k3 p1 -> BN -> ReLU -> MaxPool2d([p_freq, p_time or 1]) -> SE
    (``se_{i}``, with ``use_se_block``) -> dropout, then the channel-major
    flatten to L = cnn_filters[-1] * F'."""

    def __init__(self, domain: str, input_channels: int, freq_dim: int,
                 cnn_filters: Sequence[int], kernel_size_cnn_blocks: int, pool_size,
                 pool_time: str, D, dilation_mode: str, G: int, U: int,
                 kernel_size_dilated_conv: int, V: Sequence[int], V_kernel_size: int,
                 use_bias: bool, batch_norm: str, attention_impl: str,
                 spatial_dropout_rate: float = 0.5, dropout_perc: float = 0.3,
                 frontend_impl: str = "auto", use_se_block: bool = False, *,
                 qconv_impl: str = "xla", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if frontend_impl not in FRONTEND_IMPLS:
            raise ValueError(f"frontend_impl {frontend_impl!r} not in {FRONTEND_IMPLS}")
        self.frontend_impl = frontend_impl
        self.kernel_size, self.use_bias = kernel_size_cnn_blocks, use_bias
        self.dropout = Dropout(dropout_perc)
        self.use_bn = batch_norm in BN_ON_CNN
        self.use_se_block = use_se_block
        self.pools = [(int(p[0]), int(p[1]) if pool_time == "CNN" else 1) for p in pool_size]
        self.n_stages = len(cnn_filters)
        self.cnn_filters = tuple(int(c) for c in cnn_filters)
        cin, f = input_channels, freq_dim
        for i, c in enumerate(cnn_filters):
            setattr(self, f"cnn_{i}", make_conv(
                domain, cin, c, kernel_size_cnn_blocks, 2, padding=1, use_bias=use_bias,
                impl=qconv_impl, device=device, generator=generator))
            if self.use_bn:
                setattr(self, f"cnn_bn_{i}", BatchNorm(c, device=device))
            if use_se_block:
                setattr(self, f"se_{i}", SEBlock(c, device=device, generator=generator))
            cin, f = c, f // self.pools[i][0]
        self.tcn = TCBlock(
            domain, cin * f, G, U, V, V_kernel_size, pool_size, D, dilation_mode, pool_time,
            batch_norm, kernel_size_dilated_conv, attention_impl, use_bias,
            spatial_dropout_rate, qconv_impl=qconv_impl, device=device, generator=generator)

    def _ct_train_ok(self, x) -> bool:
        """Whether train mode runs every CNN stage through the kernel ops
        (``frontend_impl='ct'``): the conditions of
        ``seld_tpu/models/blocks.py::ConvTCBlock._ct_train_ok`` (3x3 bias-free
        conv, BN on, no SE block, 3 * Cin <= 32 for stage 0, frequency-only pools dividing F
        at every stage, stage 0's within K5's range, every stage's width a
        multiple of 8). On a CUDA tensor
        that fails them it raises; on the CPU it warns and the plain stages
        run."""
        if self.frontend_impl != "ct":
            return False
        f, ok = x.shape[1], True
        for pf, pt in self.pools[:self.n_stages]:
            ok = ok and pt == 1 and 1 <= pf <= conv2d_train.MAX_POOL_F and f % pf == 0
            f //= max(pf, 1)
        cin = x.shape[-1]
        ok = (ok and self.kernel_size == 3 and not self.use_bias and self.use_bn
              and not self.use_se_block and 3 * cin <= 32
              and self.pools[0][0] <= conv2d_train.max_pool_f(cin)
              and all(c % conv2d_ct_train.CIN_CHUNK == 0 for c in self.cnn_filters))
        if not ok:
            msg = ("frontend_impl='ct' asked for, but the CNN stages do not meet the K5/K9 "
                   "conditions (3x3 bias-free conv, BN on, no SE block, 3 * Cin <= 32, "
                   "frequency-only pools dividing F, stage widths a multiple of 8)")
            if x.is_cuda:   # a CUDA tensor launches the kernels or raises
                raise ValueError(msg)
            warnings.warn(f"{msg}: the plain stages run", stacklevel=3)
        return ok

    def _frontend_ct_train(self, x, generator, cross_rank=None):
        """Train-mode CNN front-end in the (B, C, F, T) layout: stage 0
        through the K5 op (``out_layout='CT'``), the later stages through the
        K9 op, dropout after each stage (drawn on the (B, C, F, T) tensor, so
        its masks differ from the channel-last stages' for the same
        generator). Each stage's BN running statistics update with
        n = B * F * T of its conv output (every rank's rows with
        ``cross_rank``). Returns (B, C', F', T)."""
        b, f_cur, t, _ = x.shape
        ranks = cross_rank.world if cross_rank is not None else 1
        h = None
        for i in range(self.n_stages):
            pf = self.pools[i][0]
            bn = getattr(self, f"cnn_bn_{i}")
            w = getattr(self, f"cnn_{i}").dense_kernel().to(x.dtype)
            if i == 0:
                h, mean, var = conv2d_train.conv2d_bn_relu_fpool_train(
                    x, w, bn.scale, bn.bias, pf, BN_EPS, out_layout="CT",
                    cross_rank=cross_rank)
            else:
                h, mean, var = conv2d_ct_train.conv2d_ct_bn_relu_fpool_train(
                    h, w, bn.scale, bn.bias, pf, BN_EPS, cross_rank=cross_rank)
            bn.update_running(mean, var, ranks * b * f_cur * t)
            f_cur //= pf
            h = self.dropout(h, True, generator, cross_rank)
        return h

    def _fused_train_ok(self, x, pool) -> bool:
        """Whether train-mode stage 0 runs the K5 op: 'auto' on a float32 or
        bfloat16 CUDA tensor, or 'fused', when the structural conditions of
        ``seld_tpu/models/blocks.py::ConvTCBlock._fused_train_ok`` hold (3x3
        bias-free conv, BN on, no SE block, 3 * Cin <= 32, a frequency-only pool dividing F
        and within K5's range)."""
        if self.frontend_impl == "xla":
            return False
        if self.frontend_impl == "auto" and not (
                x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)):
            return False
        cin = x.shape[-1]
        ok = (self.kernel_size == 3 and not self.use_bias and self.use_bn
              and not self.use_se_block and 3 * cin <= 32 and pool[1] == 1
              and pool[0] <= conv2d_train.max_pool_f(cin) and x.shape[1] % pool[0] == 0)
        if not ok and self.frontend_impl == "fused":
            msg = ("frontend_impl='fused' asked for, but stage 0 does not meet the K5 "
                   "conditions (3x3 bias-free conv, BN on, no SE block, 3 * Cin <= 32, a "
                   "frequency-only pool dividing F)")
            if x.is_cuda:   # a CUDA tensor launches the kernel or raises
                raise ValueError(msg)
            warnings.warn(f"{msg}: the plain stage runs", stacklevel=3)
        return ok

    def _stage0_fused_train(self, x, pool, cross_rank=None):
        """Train-mode stage 0 through the K5 op; updates cnn_bn_0's running
        statistics with n = B * F * T (the conv output before the pool; every
        rank's rows with ``cross_rank``)."""
        bn = self.cnn_bn_0
        w = self.cnn_0.dense_kernel().to(x.dtype)
        out, mean, var = conv2d_train.conv2d_bn_relu_fpool_train(
            x, w, bn.scale, bn.bias, pool[0], BN_EPS, cross_rank=cross_rank)
        ranks = cross_rank.world if cross_rank is not None else 1
        bn.update_running(mean, var, ranks * x.shape[0] * x.shape[1] * x.shape[2])
        return out

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        if train and self._ct_train_ok(x):
            h = self._frontend_ct_train(x, generator, cross_rank)   # (B, C, F', T)
            b, c, f, t = h.shape
            x = h.permute(0, 3, 1, 2).reshape(b, t, c * f)
            return self.tcn(x, train, generator, cross_rank)
        for i in range(self.n_stages):
            if i == 0 and train and self._fused_train_ok(x, self.pools[0]):
                x = self._stage0_fused_train(x, self.pools[0], cross_rank)
            else:
                x = getattr(self, f"cnn_{i}")(x)
                if self.use_bn:
                    x = getattr(self, f"cnn_bn_{i}")(x, train, cross_rank)
                x = max_pool_2d(torch.relu(x), self.pools[i])
                if self.use_se_block:
                    x = getattr(self, f"se_{i}")(x)
            x = self.dropout(x, train, generator, cross_rank)
        b, f, t, c = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, c * f)
        return self.tcn(x, train, generator, cross_rank)
