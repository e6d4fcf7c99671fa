"""Dual-quaternion convolution / linear ops (torch).

Counterpart of ``seld_tpu/ops/dual_quaternion.py``: stacked components
``(8, *k, Cin/8, Cout/8)`` (conv) or ``(8, Cin/8, Cout/8)`` (linear), the
assembled weight [[Q, 0], [Q_e, Q]] over (primary, dual) halves. The linear
keeps the reference's transposed-table quirk (see ``ops/hamilton.py``).
"""

from __future__ import annotations

from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel, assemble_dq_linear_kernel
from seld_tpu_torch.ops.quaternion import IntOrTuple, conv_nd, linear


def dual_quaternion_conv(x, comps, bias=None, stride: IntOrTuple = 1,
                         padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
                         groups: int = 1):
    """DQ conv: comps (8, *k, Cin/8, Cout/8), x (..., Cin) channel-last."""
    return conv_nd(x, assemble_dq_conv_kernel(comps), bias, stride, padding, dilation, groups)


def dual_quaternion_linear(x, comps, bias=None):
    """DQ linear: comps (8, Cin/8, Cout/8), x (..., Cin)."""
    return linear(x, assemble_dq_linear_kernel(comps), bias)
