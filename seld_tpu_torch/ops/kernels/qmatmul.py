"""Fused Hamilton-product matmul (K7): kernel wrapper, plain version, the
structured weight gradient and the autograd Function that joins them.

Counterpart of ``seld_tpu/ops/pallas/qmatmul.py``: out = x (M, n cin) @
assemble(comps (n, cin, cout)) + bias for n = 4 (quaternion) or 8 (dual
quaternion), with the Hamilton block weight assembled inside the kernel from
the stacked components, so that it never exists in device memory. Products
are summed in float32 and the bias, rounded to x's dtype, is added in
float32 before one rounding to x's dtype.

Orientations (``linear_table``): False is the conv table (blocks T[b][a], the
DQ zero block at in >= 4, out < 4), True the linear one (T[a][b], zero block
at in < 4, out >= 4); ``ops/hamilton.py::assemble_hamilton``. The backward,
as the JAX ``custom_vjp``: dx is K7 again on the cotangent with the
components' axes 1 and 2 swapped and the other table (the Hamilton
conjugate), dcomps the signed block sums of x^T g (:func:`structured_dw`,
x^T g a plain float32 matmul, as XLA computes it outside the JAX kernel), db
the row sum of g. The kernels are in ``csrc/hamilton_matmul.cu``, both
``mma.sync`` tensor-core GEMMs that assemble the weight tile in shared
memory: float32 in split TF32 (three TF32 products for each float32 one,
float32's accuracy; ``ops/kernels/tf32.py`` repeats its arithmetic on the
CPU), bfloat16 on bf16 operands; one entry point picks by dtype, so forward
and dx take the same kernel, both through the op ``seld::hamilton_matmul``
(``library.py``, CUDA impl :func:`hamilton_matmul_cuda`).
"""

from __future__ import annotations

from typing import Optional

import torch

from seld_tpu_torch import _build
from seld_tpu_torch.ops.hamilton import Q_TABLE, assemble_hamilton
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, require_contiguous, require_cuda, stream_handle,
)


def _check(x2d, comps, bias, n_comp):
    if n_comp not in (4, 8) or comps.ndim != 3 or comps.shape[0] != n_comp:
        raise ValueError(f"comps must be ({n_comp}, cin, cout) with n 4 or 8, got "
                         f"{tuple(comps.shape)}")
    if x2d.ndim != 2 or x2d.shape[1] != n_comp * comps.shape[1]:
        raise ValueError(f"x must be (M, {n_comp * comps.shape[1]}), got {tuple(x2d.shape)}")
    if bias is not None and tuple(bias.shape) != (n_comp * comps.shape[2],):
        raise ValueError(f"bias must be ({n_comp * comps.shape[2]},), got {tuple(bias.shape)}")


def hamilton_matmul_plain(x2d: torch.Tensor, comps: torch.Tensor, bias: Optional[torch.Tensor],
                          n_comp: int, linear_table: bool) -> torch.Tensor:
    """Plain version: the assembled weight in comps' dtype (sign flips are
    exact), one matmul in float32 (float64 for float64 input), the bias in
    x's dtype added in that type, one rounding to x's dtype."""
    _check(x2d, comps, bias, n_comp)
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    out = x2d.to(cdt) @ assemble_hamilton(comps, linear_table).to(cdt)
    if bias is not None:
        out = out + bias.to(x2d.dtype).to(cdt)
    return out.to(x2d.dtype)


def hamilton_matmul(x2d: torch.Tensor, comps: torch.Tensor, bias: Optional[torch.Tensor],
                    n_comp: int, linear_table: bool) -> torch.Tensor:
    """x2d (M, n cin) @ assemble(comps (n, cin, cout)) + bias -> (M, n cout)
    in x's dtype (float32 or bfloat16; comps in the same dtype), through the
    op ``seld::hamilton_matmul``: CPU tensors take
    :func:`hamilton_matmul_plain`, CUDA tensors
    :func:`hamilton_matmul_cuda`."""
    _check(x2d, comps, bias, n_comp)
    return torch.ops.seld.hamilton_matmul(x2d, comps, bias, n_comp, linear_table)


def hamilton_matmul_cuda(x2d: torch.Tensor, comps: torch.Tensor,
                         bias: Optional[torch.Tensor], n_comp: int,
                         linear_table: bool) -> torch.Tensor:
    """The CUDA impl of ``seld::hamilton_matmul``: launches
    ``seld_hamilton_matmul`` (the split-TF32 kernel in float32, the bf16 one
    in bfloat16), or raises."""
    _check(x2d, comps, bias, n_comp)
    require_cuda(*((x2d, comps) if bias is None else (x2d, comps, bias)))
    require_contiguous(x=x2d, comps=comps)
    if comps.dtype != x2d.dtype:
        raise TypeError(f"comps must be {x2d.dtype}, got {comps.dtype}")
    m, cout = x2d.shape[0], n_comp * comps.shape[2]
    b = None if bias is None else bias.to(x2d.dtype).contiguous()   # no copy in the usual case
    out = torch.empty((m, cout), dtype=x2d.dtype, device=x2d.device)
    if m:
        lib = _build.load()
        err = lib.seld_hamilton_matmul(
            x2d.data_ptr(), comps.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), m, n_comp,
            comps.shape[1], comps.shape[2], int(linear_table), dtype_code(x2d),
            stream_handle(x2d.device))
        _build.check(err, "seld_hamilton_matmul")
        launch_counts["hamilton_matmul"] += 1
    return out


def structured_dw(dw_full: torch.Tensor, cin_c: int, cout_c: int, n_comp: int,
                  linear_table: bool) -> torch.Tensor:
    """The dense (n cin, n cout) weight gradient summed into the signed
    component gradients (n, cin, cout): ``seld_tpu/ops/pallas/qmatmul.py::
    _structured_dw``, in dw_full's dtype."""
    dcomp = [torch.zeros((cin_c, cout_c), dtype=dw_full.dtype, device=dw_full.device)
             for _ in range(n_comp)]

    def blk(r, c, a, b):
        return dw_full[r + a * cin_c: r + (a + 1) * cin_c, c + b * cout_c: c + (b + 1) * cout_c]

    def q_grad(block_fn, base):
        for a in range(4):
            for b in range(4):
                idx, sgn = Q_TABLE[a][b] if linear_table else Q_TABLE[b][a]
                dcomp[base + idx] = dcomp[base + idx] + sgn * block_fn(a, b)

    if n_comp == 4:
        q_grad(lambda a, b: blk(0, 0, a, b), 0)
    else:
        four_i, four_o = 4 * cin_c, 4 * cout_c
        # Q sits on the diagonal twice, Q_e in one off-diagonal corner
        q_grad(lambda a, b: blk(0, 0, a, b) + blk(four_i, four_o, a, b), 0)
        if linear_table:
            q_grad(lambda a, b: blk(four_i, 0, a, b), 4)
        else:
            q_grad(lambda a, b: blk(0, four_o, a, b), 4)
    return torch.stack(dcomp)


class _HamiltonMatmulFn(torch.autograd.Function):
    """Forward :func:`hamilton_matmul`; backward dx by :func:`hamilton_matmul`
    on the conjugate (swapped component axes, the other table), dcomps by
    :func:`structured_dw` of x^T g in float32, db the row sum of g."""

    @staticmethod
    def forward(ctx, x2d, comps, bias, n_comp, linear_table):
        ctx.save_for_backward(x2d, comps)
        ctx.n_comp, ctx.linear_table = n_comp, linear_table
        ctx.bias_dtype = None if bias is None else bias.dtype
        return hamilton_matmul(x2d, comps, bias, n_comp, linear_table)

    @staticmethod
    def backward(ctx, g):
        x2d, comps = ctx.saved_tensors
        n, table = ctx.n_comp, ctx.linear_table
        g = g.contiguous()
        dx = dcomps = db = None
        if ctx.needs_input_grad[0]:
            comps_t = comps.transpose(1, 2).contiguous()
            dx = hamilton_matmul(g, comps_t, None, n, not table).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            cdt = torch.promote_types(x2d.dtype, torch.float32)
            dw_full = x2d.to(cdt).t() @ g.to(cdt)
            dcomps = structured_dw(dw_full, comps.shape[1], comps.shape[2], n,
                                   table).to(comps.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.sum(0).to(ctx.bias_dtype)
        return dx, dcomps, db, None, None


def _flatten_apply(x: torch.Tensor, comps: torch.Tensor, bias, n_comp: int,
                   linear_table: bool) -> torch.Tensor:
    lead = x.shape[:-1]
    out = _HamiltonMatmulFn.apply(x.reshape(-1, x.shape[-1]).contiguous(), comps.contiguous(),
                                  bias, n_comp, linear_table)
    return out.reshape(*lead, out.shape[-1])


def pallas_q_linear(x: torch.Tensor, comps: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable quaternion linear through K7: x (..., 4 cin), comps (4,
    cin, cout) -> (..., 4 cout); ``quaternion_linear``'s semantics, and those
    of a 1x1 quaternion conv on channel-last activations."""
    return _flatten_apply(x, comps, bias, 4, linear_table=False)


def pallas_dq_linear(x: torch.Tensor, comps: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     conv_table: bool = False) -> torch.Tensor:
    """Differentiable dual-quaternion linear through K7: x (..., 8 cin), comps
    (8, cin, cout) -> (..., 8 cout). ``conv_table=False`` is the reference's
    DQ-linear orientation, ``True`` the conv one (1x1 DQ convolutions)."""
    return _flatten_apply(x, comps, bias, 8, linear_table=not conv_table)
