"""Layer modules: quaternion / dual-quaternion / real conv and linear,
eval-mode BatchNorm, and the max-pool helpers.

Counterpart of ``seld_tpu/models/layers.py``. Activations are channel-last,
as in the JAX package: 1-D convs take ``(B, T, C)``, 2-D convs ``(B, H, W,
C)``. Parameters keep the JAX names and layouts:

- ``HamiltonConv.w``: ``(n, *k, Cin/n, Cout/n)``; ``HamiltonLinear.w``:
  ``(n, Cin/n, Cout/n)``; ``b``: ``(Cout,)``;
- ``RealConv.w``: ``(*k, Cin, Cout)``; ``Dense.kernel``: ``(in, out)``,
  ``Dense.bias``: ``(out,)``;
- ``BatchNorm.scale`` / ``.bias`` parameters, ``.mean`` / ``.var`` buffers.

Unlike flax, a torch module owns its parameters before it sees an input, so
each constructor takes the input width. Parameters are made on ``device``;
with a ``generator`` they are drawn from it (as the JAX initializers draw),
otherwise they start as zeros (BatchNorm as identity) for a weight import.
The slice is inference only: there is no dropout and BatchNorm always uses
its running statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_conv, dual_quaternion_linear
from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel, assemble_q_kernel
from seld_tpu_torch.ops.inits import component_init, he_uniform, lecun_normal
from seld_tpu_torch.ops.quaternion import conv_nd, linear, quaternion_conv, quaternion_linear

IntOrTuple = Union[int, Sequence[int]]
BN_EPS = 1e-5


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _param(shape, device, init=None) -> nn.Parameter:
    t = torch.zeros(tuple(shape), device=device) if init is None else init.to(device)
    return nn.Parameter(t)


class HamiltonConv(nn.Module):
    """Quaternion (n_components=4) or dual-quaternion (8) convolution."""

    def __init__(self, in_features: int, features: int, kernel_size: IntOrTuple,
                 ndim: int = 1, n_components: int = 4, padding: IntOrTuple = 0,
                 dilation: IntOrTuple = 1, use_bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = n_components
        if in_features % n or features % n:
            raise ValueError(f"channels ({in_features}->{features}) must divide "
                             f"n_components={n}")
        self.n_components = n
        self.padding, self.dilation = padding, dilation
        shape = (*_ntuple(kernel_size, ndim), in_features // n, features // n)
        init = component_init(shape, generator, n) if generator is not None else None
        self.w = _param((n, *shape), device, init)
        self.b = _param((features,), device) if use_bias else None

    def dense_kernel(self) -> torch.Tensor:
        """The assembled real kernel (*k, Cin, Cout)."""
        assemble = assemble_q_kernel if self.n_components == 4 else assemble_dq_conv_kernel
        return assemble(self.w)

    def forward(self, x):
        fn = quaternion_conv if self.n_components == 4 else dual_quaternion_conv
        return fn(x, self.w.to(x.dtype), self.b, padding=self.padding, dilation=self.dilation)


class RealConv(nn.Module):
    """Real conv in the same channel-last interface (torch-style padding)."""

    def __init__(self, in_features: int, features: int, kernel_size: IntOrTuple,
                 ndim: int = 1, padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
                 use_bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding, self.dilation = padding, dilation
        shape = (*_ntuple(kernel_size, ndim), in_features, features)
        init = he_uniform(shape, generator) if generator is not None else None
        self.w = _param(shape, device, init)
        self.b = _param((features,), device) if use_bias else None

    def dense_kernel(self) -> torch.Tensor:
        return self.w

    def forward(self, x):
        return conv_nd(x, self.w, self.b, padding=self.padding, dilation=self.dilation)


class HamiltonLinear(nn.Module):
    """Quaternion (4) or dual-quaternion (8) linear layer."""

    def __init__(self, in_features: int, features: int, n_components: int = 4,
                 use_bias: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = n_components
        if in_features % n or features % n:
            raise ValueError(f"features ({in_features}->{features}) must divide "
                             f"n_components={n}")
        self.n_components = n
        shape = (in_features // n, features // n)
        init = component_init(shape, generator, n) if generator is not None else None
        self.w = _param((n, *shape), device, init)
        self.b = _param((features,), device) if use_bias else None

    def forward(self, x):
        fn = quaternion_linear if self.n_components == 4 else dual_quaternion_linear
        return fn(x, self.w.to(x.dtype), self.b)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), optional ``bias`` (out,)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        init = lecun_normal((in_features, features), generator) if generator is not None else None
        self.kernel = _param((in_features, features), device, init)
        self.bias = _param((features,), device) if use_bias else None

    def forward(self, x):
        return linear(x, self.kernel, self.bias)


def make_conv(domain: str, in_features: int, features: int, kernel_size: IntOrTuple,
              ndim: int, *, padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
              use_bias: bool = True, device=None,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """Domain-dispatched stride-1 conv: the exact strings 'Q' and 'DQ'; anything
    else real."""
    kw = dict(padding=padding, dilation=dilation, use_bias=use_bias, device=device,
              generator=generator)
    if domain in ("Q", "DQ"):
        return HamiltonConv(in_features, features, kernel_size, ndim,
                            n_components=4 if domain == "Q" else 8, **kw)
    return RealConv(in_features, features, kernel_size, ndim, **kw)


def make_linear(domain: str, in_features: int, features: int, use_bias: bool = True, *,
                device=None, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Domain-dispatched linear: 'Q' / 'DQ' Hamilton, anything else Dense."""
    if domain in ("Q", "DQ"):
        return HamiltonLinear(in_features, features, 4 if domain == "Q" else 8, use_bias,
                              device=device, generator=generator)
    return Dense(in_features, features, use_bias, device=device, generator=generator)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (eps 1e-5): learned ``scale`` /
    ``bias``, running ``mean`` / ``var`` buffers."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift) with bn(x) == x * inv + shift."""
        inv = self.scale / torch.sqrt(self.var + BN_EPS)
        return inv, self.bias - self.mean * inv

    def forward(self, x):
        # flax _normalize's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        dt = x.dtype
        mul = torch.rsqrt(self.var.to(dt) + BN_EPS) * self.scale.to(dt)
        return (x - self.mean.to(dt)) * mul + self.bias.to(dt)


def max_pool_time(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Max-pool (B, T, C) over time, VALID with floor division."""
    if pool == 1:
        return x
    return F.max_pool1d(x.transpose(1, 2), pool, pool).transpose(1, 2)


def max_pool_2d(x: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """Max-pool (B, F, T, C) over (F, T), VALID with floor division."""
    pf, pt = int(pool[0]), int(pool[1])
    if pf == 1 and pt == 1:
        return x
    return F.max_pool2d(x.permute(0, 3, 1, 2), (pf, pt), (pf, pt)).permute(0, 2, 3, 1)
