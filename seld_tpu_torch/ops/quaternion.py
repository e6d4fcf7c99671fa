"""Quaternion convolution / linear ops (torch).

Counterpart of ``seld_tpu/ops/quaternion.py`` in the same channel-last
interface: conv inputs ``(B, T, C)`` (1-D) or ``(B, H, W, C)`` (2-D), kernels
``(*k, Cin, Cout)``; linear inputs ``(..., Cin)`` with weights ``(Cin, Cout)``.
Stacked component weights are ``(4, *k, Cin/4, Cout/4)`` or ``(4, Cin/4,
Cout/4)``. Inside, ``conv_nd`` moves channels first and calls torch's conv.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from seld_tpu_torch.ops.hamilton import assemble_q_kernel

IntOrTuple = Union[int, Sequence[int]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _ntuple(v: IntOrTuple, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride: IntOrTuple = 1,
            padding: IntOrTuple = 0, dilation: IntOrTuple = 1, groups: int = 1) -> torch.Tensor:
    """Real channel-last N-D convolution with torch-style symmetric padding.

    x (B, *spatial, Cin), kernel (*k, Cin/groups, Cout) -> (B, *spatial', Cout).
    The kernel is cast to x's dtype."""
    n = x.ndim - 2
    if n not in _CONV or kernel.ndim != n + 2:
        raise ValueError(f"conv_nd: x {tuple(x.shape)} and kernel {tuple(kernel.shape)}")
    xc = x.movedim(-1, 1)
    w = kernel.to(x.dtype).permute(n + 1, n, *range(n))  # (Cout, Cin/groups, *k)
    y = _CONV[n](xc, w, None, _ntuple(stride, n), _ntuple(padding, n),
                 _ntuple(dilation, n), groups)
    y = y.movedim(1, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """x (..., Cin) @ w (Cin, Cout) (+ bias), in x's dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def quaternion_conv(x, comps, bias=None, stride: IntOrTuple = 1, padding: IntOrTuple = 0,
                    dilation: IntOrTuple = 1, groups: int = 1) -> torch.Tensor:
    """Quaternion conv: comps (4, *k, Cin/4, Cout/4), x (..., Cin) channel-last."""
    return conv_nd(x, assemble_q_kernel(comps), bias, stride, padding, dilation, groups)


def quaternion_linear(x, comps, bias=None) -> torch.Tensor:
    """Quaternion linear: comps (4, Cin/4, Cout/4), x (..., Cin)."""
    return linear(x, assemble_q_kernel(comps), bias)
