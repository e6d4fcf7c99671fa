"""Layer modules: quaternion / dual-quaternion / real conv and linear,
BatchNorm, dropout, and the max-pool helpers.

Counterpart of ``seld_tpu/models/layers.py``. Activations are channel-last,
as in the JAX package: 1-D convs take ``(B, T, C)``, 2-D convs ``(B, H, W,
C)``. Parameters keep the JAX names and layouts:

- ``HamiltonConv.w``: ``(n, *k, Cin/n, Cout/n)``; ``HamiltonLinear.w``:
  ``(n, Cin/n, Cout/n)``; ``b``: ``(Cout,)``;
- ``RealConv.w``: ``(*k, Cin, Cout)``; ``Dense.kernel``: ``(in, out)``,
  ``Dense.bias``: ``(out,)``;
- ``BatchNorm.scale`` / ``.bias`` parameters, ``.mean`` / ``.var`` buffers.

Train mode is an argument, as in flax (``train=True``), not the module's
``training`` flag: BatchNorm then normalizes with batch statistics and
updates its running ones, and dropout draws its masks from an explicit
``torch.Generator`` on the input's device.

Unlike flax, a torch module owns its parameters before it sees an input, so
each constructor takes the input width. Parameters are made on ``device``;
with a ``generator`` they are drawn from it (as the JAX initializers draw),
otherwise they start as zeros (BatchNorm as identity) for a weight import.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_conv, dual_quaternion_linear
from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel, assemble_q_kernel
from seld_tpu_torch.ops.inits import component_init, he_uniform, lecun_normal
from seld_tpu_torch.ops.kernels.qmatmul import pallas_dq_linear, pallas_q_linear
from seld_tpu_torch.ops.kernels.quant import int8_matmul, quantize_hamilton
from seld_tpu_torch.ops.quaternion import conv_nd, linear, quaternion_conv, quaternion_linear

IntOrTuple = Union[int, Sequence[int]]
# the Hamilton layers' matmul route: plain ops, K7 (fused Hamilton matmul) or
# K8 (int8 post-training quantization, serving only)
QCONV_IMPLS = ("xla", "pallas", "int8")
BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax retention; torch's momentum 0.1


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _param(shape, device, init=None) -> nn.Parameter:
    t = torch.zeros(tuple(shape), device=device) if init is None else init.to(device)
    return nn.Parameter(t)


def _check_impl(impl: str) -> None:
    if impl not in QCONV_IMPLS:
        raise ValueError(f"impl {impl!r} not in {QCONV_IMPLS}")


def _hamilton_matmul(x, comps, bias, impl: str, dq_linear: bool):
    """The Hamilton matmul x (..., Cin) @ assemble(comps (n, Cin/n, Cout/n))
    + bias through K7 ('pallas', differentiable) or K8 ('int8': the weight
    quantized per output channel from the float32 components on every call,
    as the JAX layers do; no gradient), in x's dtype; the bias rounded to
    x's dtype first. A quaternion weight has one orientation; a DQ weight
    takes the linear table with ``dq_linear``, else the conv table."""
    bd = None if bias is None else bias.to(x.dtype)
    linear_table = dq_linear and comps.shape[0] == 8
    if impl == "pallas":
        if comps.shape[0] == 4:
            return pallas_q_linear(x, comps.to(x.dtype), bd)
        return pallas_dq_linear(x, comps.to(x.dtype), bd, conv_table=not linear_table)
    w_q, w_scale = quantize_hamilton(comps, linear_table)
    return int8_matmul(x, w_q, w_scale, bd)


class HamiltonConv(nn.Module):
    """Quaternion (n_components=4) or dual-quaternion (8) convolution.

    ``impl`` 'pallas' (K7) or 'int8' (K8) routes a pointwise conv (every
    kernel size 1; the port's convs are stride 1) through the Hamilton
    matmul on the conv table, as ``seld_tpu/models/layers.py::HamiltonConv``
    does; spatial convs and 'xla' take the plain conv."""

    def __init__(self, in_features: int, features: int, kernel_size: IntOrTuple,
                 ndim: int = 1, n_components: int = 4, padding: IntOrTuple = 0,
                 dilation: IntOrTuple = 1, use_bias: bool = True, impl: str = "xla", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        n = n_components
        if in_features % n or features % n:
            raise ValueError(f"channels ({in_features}->{features}) must divide "
                             f"n_components={n}")
        _check_impl(impl)
        self.n_components = n
        self.padding, self.dilation = padding, dilation
        self.impl = impl
        self.pointwise = all(k == 1 for k in _ntuple(kernel_size, ndim))
        shape = (*_ntuple(kernel_size, ndim), in_features // n, features // n)
        init = component_init(shape, generator, n) if generator is not None else None
        self.w = _param((n, *shape), device, init)
        self.b = _param((features,), device) if use_bias else None

    def dense_kernel(self) -> torch.Tensor:
        """The assembled real kernel (*k, Cin, Cout)."""
        assemble = assemble_q_kernel if self.n_components == 4 else assemble_dq_conv_kernel
        return assemble(self.w)

    def forward(self, x):
        if self.pointwise and self.impl != "xla":
            n, cin_c, cout_c = self.n_components, self.w.shape[-2], self.w.shape[-1]
            return _hamilton_matmul(x, self.w.reshape(n, cin_c, cout_c), self.b, self.impl,
                                    dq_linear=False)
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
    """Quaternion (4) or dual-quaternion (8) linear layer; ``impl`` 'pallas'
    (K7) or 'int8' (K8) runs the Hamilton matmul on the linear table (the
    reference's DQ-linear orientation). ``forward(x, impl=...)`` overrides
    the layer's impl for one call."""

    def __init__(self, in_features: int, features: int, n_components: int = 4,
                 use_bias: bool = True, impl: str = "xla", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = n_components
        if in_features % n or features % n:
            raise ValueError(f"features ({in_features}->{features}) must divide "
                             f"n_components={n}")
        _check_impl(impl)
        self.n_components = n
        self.impl = impl
        shape = (in_features // n, features // n)
        init = component_init(shape, generator, n) if generator is not None else None
        self.w = _param((n, *shape), device, init)
        self.b = _param((features,), device) if use_bias else None

    def forward(self, x, impl: Optional[str] = None):
        impl = self.impl if impl is None else impl
        if impl != "xla":
            return _hamilton_matmul(x, self.w, self.b, impl, dq_linear=True)
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

    def forward(self, x, impl: Optional[str] = None):
        """``impl`` is accepted for the Hamilton layers' interface and ignored."""
        return linear(x, self.kernel, self.bias)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the channels of (B, ..., C)
    (``seld_tpu/models/layers.py::SEBlock``, reduction 8): the mean over
    every axis but batch and channel, ``Dense_0`` (C -> max(C // 8, 1)),
    ReLU, ``Dense_1`` (back to C), sigmoid, then x scaled per (batch,
    channel) in x's dtype. The squeeze runs in x's dtype promoted with the
    weights' (float32 for a bfloat16 stage, as flax's Dense promotes)."""

    def __init__(self, channels: int, reduction: int = 8, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.Dense_0 = Dense(channels, hidden, device=device, generator=generator)
        self.Dense_1 = Dense(hidden, channels, device=device, generator=generator)

    def excite(self, s: torch.Tensor) -> torch.Tensor:
        """(B, C) channel means -> (B, C) sigmoid scales, in s's dtype
        promoted with the weights'."""
        s = s.to(torch.promote_types(s.dtype, self.Dense_0.kernel.dtype))
        return torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(s))))

    def forward(self, x):
        axes = tuple(range(1, x.ndim - 1))
        s = self.excite(x.mean(axes))
        return x * s.reshape(s.shape[0], *([1] * len(axes)), s.shape[-1]).to(x.dtype)


def make_conv(domain: str, in_features: int, features: int, kernel_size: IntOrTuple,
              ndim: int, *, padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
              use_bias: bool = True, impl: str = "xla", device=None,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """Domain-dispatched stride-1 conv: the exact strings 'Q' and 'DQ'; anything
    else real (``impl`` is the Hamilton layers' and is ignored by RealConv)."""
    kw = dict(padding=padding, dilation=dilation, use_bias=use_bias, device=device,
              generator=generator)
    if domain in ("Q", "DQ"):
        return HamiltonConv(in_features, features, kernel_size, ndim,
                            n_components=4 if domain == "Q" else 8, impl=impl, **kw)
    return RealConv(in_features, features, kernel_size, ndim, **kw)


def make_linear(domain: str, in_features: int, features: int, use_bias: bool = True, *,
                impl: str = "xla", device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Domain-dispatched linear: 'Q' / 'DQ' Hamilton (with ``impl``), anything
    else Dense."""
    if domain in ("Q", "DQ"):
        return HamiltonLinear(in_features, features, 4 if domain == "Q" else 8, use_bias,
                              impl, device=device, generator=generator)
    return Dense(in_features, features, use_bias, device=device, generator=generator)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (eps 1e-5): learned ``scale`` / ``bias``,
    running ``mean`` / ``var`` buffers.

    Eval mode normalizes with the running statistics. Train mode
    (``train=True``, ``seld_tpu/models/layers.py::BatchNorm``) normalizes with
    the biased batch variance, E[x^2] - E[x]^2 in float32 (float64 for
    float64 input), and updates the running statistics in place with
    retention 0.9, the variance with torch's unbiased ``var * n / (n - 1)``.
    With a ``cross_rank`` hook (``parallel/cross_rank.py``) the statistics
    are the global batch's: the sum and the sum of squares are summed over
    the ranks (their gradient too), and n counts every rank's rows."""

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

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Fold batch statistics of ``n`` elements per channel into the running
        ones (``mean`` / ``var`` biased, as normalization uses them)."""
        keep = BN_MOMENTUM
        rdt = self.mean.dtype
        self.mean.copy_(keep * self.mean + (1 - keep) * mean.to(rdt))
        self.var.copy_(keep * self.var + (1 - keep) * var.to(rdt) * (n / max(n - 1, 1)))

    def forward(self, x, train: bool = False, cross_rank=None):
        if train:
            axes = tuple(range(x.ndim - 1))
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            n = x.numel() // x.shape[-1]
            if cross_rank is None:
                mean = xs.mean(axes)
                var = torch.clamp((xs * xs).mean(axes) - mean * mean, min=0.0)
            else:
                sums = cross_rank.sum_differentiable(
                    torch.stack([xs.sum(axes), (xs * xs).sum(axes)]), "BN")
                n *= cross_rank.world
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            self.update_running(mean, var, n)
            mul = torch.rsqrt(var + BN_EPS) * self.scale.to(xs.dtype)
            return ((xs - mean) * mul + self.bias.to(xs.dtype)).to(x.dtype)
        # flax _normalize's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        dt = x.dtype
        mul = torch.rsqrt(self.var.to(dt) + BN_EPS) * self.scale.to(dt)
        return (x - self.mean.to(dt)) * mul + self.bias.to(dt)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator], broadcast_dims: Sequence[int] = (),
            cross_rank=None):
    """flax ``nn.Dropout``: in train mode keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); the mask has size 1 along
    ``broadcast_dims``. Draws from ``generator`` (on x's device). With a
    ``cross_rank`` hook x is this rank's rows of a global batch: the mask is
    drawn at the global batch and this rank takes its rows, so ranks whose
    generators agree draw what one process would at the global batch."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]
    keep = 1.0 - rate
    if cross_rank is not None:
        shape[0] *= cross_rank.world
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if cross_rank is not None:
        mask = mask[cross_rank.rows(x.shape[0])]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``); parameter-free."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        return dropout(x, self.rate, train, generator, cross_rank=cross_rank)


class SpatialDropout1D(Dropout):
    """Channel-wise dropout on (B, T, C), torch ``nn.Dropout1d`` semantics
    (``seld_tpu/models/layers.py::SpatialDropout1D``): a dropped channel is
    dropped across all of time."""

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        return dropout(x, self.rate, train, generator, broadcast_dims=(1,),
                       cross_rank=cross_rank)


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
