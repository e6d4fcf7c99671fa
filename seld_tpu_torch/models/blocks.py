"""SELD-TCN building blocks, eval mode: gated ResBlock, TC block, CNN front-end.

Counterpart of ``seld_tpu/models/blocks.py`` (single-trunk forward). The TCN
works on channel-last ``(B, T, L)``, the CNN front-end on ``(B, F, T, C)``.
Two reference quirks are kept: the residual is added to the pre-activated
``h`` (``tanh(bn_pre(x))``), not to the block input; and the CNN output is
flattened channel-major, so TCN feature ``c * F' + f`` is channel c at
frequency f.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from seld_tpu_torch.models.attention import MultiHeadAttention
from seld_tpu_torch.models.layers import BatchNorm, make_conv, max_pool_2d, max_pool_time

BN_ON_TCN = {"BN", "BN_on_TCN", "BNonTCN"}
BN_ON_CNN = {"BN", "BN_on_CNN", "BNonCNN"}


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
    (h + res, skip) with h = tanh(bn_pre(x)) when BN is on the TCN, else x."""

    def __init__(self, domain: str, in_features: int, G: int, U: int, kernel_size: int = 3,
                 dilation: int = 1, use_bias: bool = True, batch_norm: str = "BN", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        L = in_features
        self.use_bn = batch_norm in BN_ON_TCN
        self.dilation = dilation
        self.padding = ((kernel_size - 1) * dilation) // 2
        conv = dict(use_bias=use_bias, device=device, generator=generator)
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

    def forward(self, x):
        h = torch.tanh(self.bn_pre(x)) if self.use_bn else x
        y_f, y_g = self.conv_filter(h), self.conv_gate(h)
        if self.use_bn:
            y_f, y_g = self.bn_filter(y_f), self.bn_gate(y_g)
        y = torch.tanh(y_f) * torch.sigmoid(y_g)
        return h + self.conv_res(y), self.conv_skip(y)


class TCBlock(nn.Module):
    """Dilated TCN stack, then relu -> pool -> conv1 -> MHA(8 heads) -> relu ->
    pool -> conv2 -> tanh -> pool on (B, T, L) (time pools only when
    pool_time == 'TCN')."""

    def __init__(self, domain: str, in_features: int, G: int, U: int, V: Sequence[int],
                 V_kernel_size: int, pool_size, D, dilation_mode: str, pool_time: str,
                 batch_norm: str, kernel_size_dilated_conv: int, attention_impl: str,
                 use_bias: bool, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool_size, self.pool_time = pool_size, pool_time
        self.n_blocks = 0
        for idx, dil in enumerate(dilation_schedule(D, dilation_mode)):
            setattr(self, f"resblock_{idx}", ResBlock(
                domain, in_features, G, U, kernel_size_dilated_conv, dil, use_bias,
                batch_norm, device=device, generator=generator))
            self.n_blocks += 1
        kw = dict(padding=1, use_bias=use_bias, device=device, generator=generator)
        self.conv1 = make_conv(domain, U, V[0], V_kernel_size, 1, **kw)
        self.attention = MultiHeadAttention(V[0], 8, attention_impl, device=device,
                                            generator=generator)
        self.conv2 = make_conv(domain, V[0], V[1], V_kernel_size, 1, **kw)

    def _pool(self, x, i):
        return max_pool_time(x, int(self.pool_size[i][1])) if self.pool_time == "TCN" else x

    def forward(self, x):
        skip_sum = None
        for idx in range(self.n_blocks):
            x, skip = getattr(self, f"resblock_{idx}")(x)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        out = self.conv1(self._pool(torch.relu(skip_sum), 0))
        out = self.attention(out, out, out)
        out = self.conv2(self._pool(torch.relu(out), 1))
        return self._pool(torch.tanh(out), 2)


class ConvTCBlock(nn.Module):
    """CNN front-end + TCN on (B, F, T, C) -> (B, T_pooled, V[-1]): per stage
    conv2d k3 p1 -> BN -> ReLU -> MaxPool2d([p_freq, p_time or 1]), then the
    channel-major flatten to L = cnn_filters[-1] * F'."""

    def __init__(self, domain: str, input_channels: int, freq_dim: int,
                 cnn_filters: Sequence[int], kernel_size_cnn_blocks: int, pool_size,
                 pool_time: str, D, dilation_mode: str, G: int, U: int,
                 kernel_size_dilated_conv: int, V: Sequence[int], V_kernel_size: int,
                 use_bias: bool, batch_norm: str, attention_impl: str, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_bn = batch_norm in BN_ON_CNN
        self.pools = [(int(p[0]), int(p[1]) if pool_time == "CNN" else 1) for p in pool_size]
        self.n_stages = len(cnn_filters)
        cin, f = input_channels, freq_dim
        for i, c in enumerate(cnn_filters):
            setattr(self, f"cnn_{i}", make_conv(
                domain, cin, c, kernel_size_cnn_blocks, 2, padding=1, use_bias=use_bias,
                device=device, generator=generator))
            if self.use_bn:
                setattr(self, f"cnn_bn_{i}", BatchNorm(c, device=device))
            cin, f = c, f // self.pools[i][0]
        self.tcn = TCBlock(
            domain, cin * f, G, U, V, V_kernel_size, pool_size, D, dilation_mode, pool_time,
            batch_norm, kernel_size_dilated_conv, attention_impl, use_bias,
            device=device, generator=generator)

    def forward(self, x):
        for i in range(self.n_stages):
            x = getattr(self, f"cnn_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"cnn_bn_{i}")(x)
            x = max_pool_2d(torch.relu(x), self.pools[i])
        b, f, t, c = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, c * f)
        return self.tcn(x)
