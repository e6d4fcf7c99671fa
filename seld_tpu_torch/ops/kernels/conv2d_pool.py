"""Fused CNN-frontend stage (K2 + K3): kernel wrapper and plain version.

``maxpool_f(relu(conv3x3(x, w) * scale + bias))`` with zero padding 1 and a
VALID frequency max-pool of ``pool_f`` rows (time is not pooled), writing only
the pooled output. Counterpart of
``seld_tpu/ops/pallas/conv2d_pool.py::conv2d_smallcin_thin_bn_relu_fpool``
(Cin <= 8) and ``::conv2d_widecin_ct_bn_relu_fpool`` (Cin % 8 == 0), in the
NCHW layout (H = frequency, W = time) instead of the TPU's CT/CTH layouts.
The kernels are ``csrc/conv3x3_bn_relu_fpool.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)

MAX_POOL_F = 48  # keeps the smallcin halo (pool_f + 2 rows) in shared memory


def _check(x, w, scale, bias, pool_f) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Cin, F, T), got {tuple(x.shape)}")
    cin = x.shape[1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
    if pool_f < 1 or x.shape[2] % pool_f:
        raise ValueError(f"F={x.shape[2]} must divide into pool_f={pool_f} rows")


def conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f: int) -> torch.Tensor:
    """Plain version: conv in x's dtype, affine + ReLU + pool in float32
    (float64 for float64 input), result in x's dtype."""
    _check(x, w, scale, bias, pool_f)
    y = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    adt = torch.promote_types(x.dtype, torch.float32)
    y = y.to(adt) * scale.to(adt)[:, None, None] + bias.to(adt)[:, None, None]
    y = F.max_pool2d(torch.relu(y), (pool_f, 1))
    return y.to(x.dtype)


def conv2d_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """x (B, Cin, F, T), w (3, 3, Cin, Cout) in x's dtype, scale/bias (Cout,)
    float32 -> (B, Cout, F/pool_f, T) in x's dtype.

    CPU tensors take :func:`conv2d_bn_relu_fpool_plain`. CUDA tensors launch
    ``seld_conv3x3_smallcin`` for Cin <= 8 and ``seld_conv3x3_widecin`` for
    Cin % 8 == 0; other Cin raise."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    require_contiguous(x=x, w=w, scale=scale, bias=bias)
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    b, cin, f, t = x.shape
    cout = w.shape[3]
    if cin <= 8:
        name = "conv3x3_smallcin"
        if pool_f > MAX_POOL_F:
            raise ValueError(f"pool_f {pool_f} > {MAX_POOL_F}")
    elif cin % 8 == 0:
        name = "conv3x3_widecin"
    else:
        raise ValueError(f"no kernel for Cin={cin} (needs Cin <= 8 or Cin % 8 == 0)")
    if b * (f // pool_f) > 65535:
        raise ValueError("B * F / pool_f exceeds the grid's z range")
    out = torch.empty((b, cout, f // pool_f, t), dtype=x.dtype, device=x.device)
    code = dtype_code(x)
    lib = _build.load()
    fn = getattr(lib, f"seld_{name}")
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), b, cin, f, t, cout, pool_f, code,
             stream_handle(x.device))
    _build.check(err, f"seld_{name}")
    launch_counts[name] += 1
    return out
