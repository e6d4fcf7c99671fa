"""Train-mode CNN stage 1 (K5): kernel wrappers, plain versions and the
autograd Function.

Counterpart of ``seld_tpu/ops/pallas/conv2d_train.py::
conv2d_smallcin_bn_relu_fpool_train``: x (B, F, T, Cin) with 3 * Cin <= 32
(the reference's wide-pack range: Cin <= 10), w (3, 3, Cin,
Cout), gamma / beta (Cout,) -> (out (B, F/pf, T, Cout) =
maxpool_f(relu(bn_batchstats(conv(x, w)))), mean, var), with the biased batch
statistics over N = B * F * T and a backward for (w, gamma, beta) only: the
stage's input is data, and the cotangents of mean and var (which feed the
running statistics) are ignored. The max-pool routes its gradient to the
first row holding the max.

Five passes. F1, B1 and B2 are wrappers here that launch their kernels
(``csrc/conv3x3_train.cu``) for CUDA tensors and run their plain versions
for CPU tensors; F2 is the serving stage-1 kernel itself:

- F1 :func:`conv_train_stats` — per-channel sum and sum of squares of the conv;
- (torch) mean, var, the BN affine;
- F2 — conv + affine + ReLU + frequency max-pool: on CUDA tensors
  ``conv2d_pool.conv2d_smallcin_bn_relu_fpool`` (K2's
  ``seld_conv3x3_smallcin``, its launches counted under that name) fed the
  batch-statistics affine, on CPU tensors :func:`conv_train_fwd_plain`;
- B1 :func:`sel_stats` — S_g, S_gx from (out, cotangent) where out > 0;
- B2 :func:`conv_train_dw` — dW, and the exact routed S_g and sum g * acc
  that give dgamma and dbeta.

The kernels stage all Cin channels of a tile at once, 8 for Cin <= 8 and 16
for Cin 9-10 (:func:`staged_channels`), so F1, F2 and B2 run one conv row
and one summation order: B2's routing recomputes F2's pooled rows bit for
bit. (The reference runs Cin 9-10 through its wide pack, whose forward and
backward likewise share one packed row; F2 on K2w's kernel would sum in
another order than B2's recompute.) The kernels work in (B, C, F, T): the
public function takes and returns the JAX package's channel-last layout as
permuted views of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)
from seld_tpu_torch.ops.kernels.conv2d_pool import (
    BLOCK_CO, BLOCK_T, MAX_POOL_F, conv2d_smallcin_bn_relu_fpool, halo_max_pool_f,
    staged_channels,
)

TILES_PER_BLOCK = 4     # frame tiles one block walks (sizes the partial-sum rows)
MAX_CIN = 10            # the reference's wide-pack range, 3 * Cin <= 32


def kdim(cin: int) -> int:
    """B2's dW row per output channel: (tap, ci) with ci padded to
    :func:`staged_channels`."""
    return 9 * staged_channels(cin)


def max_pool_f(cin: int) -> int:
    """The largest pool_f K5 takes at this Cin: B2 keeps the pool_f + 2 halo
    rows, the weights and a g_z tile in one block's shared memory (41 rows
    for Cin <= 8, 17 for Cin 9-10)."""
    return halo_max_pool_f(cin, 4 * BLOCK_CO * (BLOCK_T + 1))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check(x, w, pool_f) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Cin, F, T), got {tuple(x.shape)}")
    cin = x.shape[1]
    if not 1 <= cin <= MAX_CIN:
        raise ValueError(f"stage 1 takes 3 * Cin <= 32 (Cin <= {MAX_CIN}), got {cin}")
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    top = max_pool_f(cin)
    if not 1 <= pool_f <= top or x.shape[2] % pool_f:
        raise ValueError(f"F={x.shape[2]} must divide into pool_f={pool_f} rows "
                         f"(pool_f <= {top} at Cin {cin})")


def _conv_plain(x, w) -> torch.Tensor:
    """The conv in float32 (float64 for float64 input) on the input's values:
    (B, Cout, F, T), as the kernels accumulate it."""
    cdt = _acc_dtype(x)
    return F.conv2d(x.to(cdt), w.to(cdt).permute(3, 2, 0, 1), padding=1)


def _grid_rows(x, pool_f) -> int:
    b, _, f, t = x.shape
    n_tiles = -(-t // BLOCK_T)
    return b * (f // pool_f) * -(-n_tiles // TILES_PER_BLOCK)


def _launch_prelude(x, w, name):
    require_contiguous(x=x, w=w)
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w is {w.dtype}, x is {x.dtype}")
    return dtype_code(x), _build.load()


def _col(t: torch.Tensor) -> torch.Tensor:
    """A per-channel float32 column for the kernels."""
    return t.detach().to(torch.float32).contiguous()


# ---- F1: batch statistics --------------------------------------------------

def conv_train_stats_plain(x, w) -> torch.Tensor:
    """(2 * Cout,) = [sum | sum of squares] of conv(x, w) over (B, F, T)."""
    acc = _conv_plain(x, w)
    return torch.cat([acc.sum((0, 2, 3)), (acc * acc).sum((0, 2, 3))])


def conv_train_stats(x: torch.Tensor, w: torch.Tensor, pool_f: int) -> torch.Tensor:
    """x (B, Cin, F, T), w (3, 3, Cin, Cout) -> (2 * Cout,) float32 sums.
    ``pool_f`` only sets the kernel's tiling (one block per pooled row)."""
    _check(x, w, pool_f)
    if not on_cuda(x, w):
        return conv_train_stats_plain(x, w)
    code, lib = _launch_prelude(x, w, "conv_train_stats")
    b, cin, f, t = x.shape
    cout = w.shape[3]
    partials = torch.empty((_grid_rows(x, pool_f), 2 * cout), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=x.device)
    err = lib.seld_conv3x3_train_stats(
        x.data_ptr(), w.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        b, cin, f, t, cout, pool_f, TILES_PER_BLOCK, code, stream_handle(x.device))
    _build.check(err, "seld_conv3x3_train_stats")
    launch_counts["conv_train_stats"] += 1
    return sums


# ---- F2: conv + batch-stats affine + ReLU + frequency pool ------------------

def conv_train_fwd_plain(x, w, scale, bias, pool_f: int) -> torch.Tensor:
    """(B, Cout, F/pf, T) in x's dtype: the float conv, affine, ReLU, pool.

    F2's plain version. It convolves in float32 as the kernel accumulates,
    where K2's plain version (``conv2d_bn_relu_fpool_plain``) convolves in
    x's dtype: for bfloat16 that rounds before the affine and would pool
    other values than B2's plain routing recomputes."""
    y = _conv_plain(x, w)
    y = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
    return F.max_pool2d(torch.relu(y), (pool_f, 1)).to(x.dtype)


# ---- B1: S_g, S_gx from the pooled output -----------------------------------

def sel_stats_plain(out, g, p, q) -> torch.Tensor:
    """(2 * Cout,) = [sum g | sum g * (out * p - q)] over out > 0, per channel
    of (B, Cout, F', T) out and cotangent g."""
    cdt = _acc_dtype(out)
    o = out.to(cdt)
    gsel = torch.where(o > 0, g.to(cdt), torch.zeros((), dtype=cdt, device=o.device))
    xhat = o * p.to(cdt)[:, None, None] - q.to(cdt)[:, None, None]
    return torch.cat([gsel.sum((0, 2, 3)), (gsel * xhat).sum((0, 2, 3))])


def sel_stats(out: torch.Tensor, g: torch.Tensor, p: torch.Tensor,
              q: torch.Tensor) -> torch.Tensor:
    """out, g (B, Cout, F', T) of one dtype, p, q (Cout,) -> (2 * Cout,)."""
    if out.shape != g.shape or out.ndim != 4:
        raise ValueError(f"out {tuple(out.shape)} and g {tuple(g.shape)} must be one "
                         "(B, Cout, F', T) shape")
    if not on_cuda(out, g, p, q):
        return sel_stats_plain(out, g, p, q)
    require_contiguous(out=out, g=g)
    if g.dtype != out.dtype:
        raise TypeError(f"g is {g.dtype}, out is {out.dtype}")
    code, lib = dtype_code(out), _build.load()
    b, cout, fo, t = out.shape
    if cout > 65535 or b * fo > 65535:
        raise ValueError("Cout or B * F' exceeds the grid's range")
    partials = torch.empty((b * fo, 2 * cout), dtype=torch.float32, device=out.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=out.device)
    p, q = _col(p), _col(q)
    err = lib.seld_conv3x3_train_sel_stats(
        out.data_ptr(), g.data_ptr(), p.data_ptr(), q.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), b, cout, fo, t, code, stream_handle(out.device))
    _build.check(err, "seld_conv3x3_train_sel_stats")
    launch_counts["conv_train_sel_stats"] += 1
    return sums


# ---- B2: dW and the exact routed sums ---------------------------------------

def conv_train_dw_plain(x, w, g, scale, bias, a, b, pool_f: int) -> torch.Tensor:
    """(Cout * (K + 2),) = [dW (Cout, 9 taps, CC ci) | S_g | sum g_pre * acc]
    with CC = :func:`staged_channels` and K = 9 * CC (74 or 146 per channel).

    g_pre is the pooled cotangent g routed to the first row holding each
    window's max where that max is > 0; g_z = g_pre * scale - acc * a - b,
    rounded to x's dtype, is the dW product's operand."""
    cdt = _acc_dtype(x)
    acc = _conv_plain(x, w)                                       # (B, C, F, T)
    bsz, cout, f, t = acc.shape
    col = lambda v: v.to(cdt)[:, None, None]
    y = torch.relu(acc * col(scale) + col(bias)).view(bsz, cout, f // pool_f, pool_f, t)
    m, idx = y.max(dim=3)                                         # first max
    gsel = torch.where(m > 0, g.to(cdt), torch.zeros((), dtype=cdt, device=g.device))
    g_pre = torch.zeros_like(y).scatter_(3, idx.unsqueeze(3), gsel.unsqueeze(3))
    g_pre = g_pre.view(bsz, cout, f, t)
    sg = g_pre.sum((0, 2, 3))
    sga = (g_pre * acc).sum((0, 2, 3))
    g_z = (g_pre * col(scale) - acc * col(a) - col(b)).to(x.dtype).to(cdt)
    dw = torch.nn.grad.conv2d_weight(x.to(cdt), (cout, x.shape[1], 3, 3), g_z, padding=1)
    cin = x.shape[1]
    dw = F.pad(dw.permute(0, 2, 3, 1), (0, staged_channels(cin) - cin))  # (Cout, 3, 3, CC)
    return torch.cat([dw.reshape(-1), sg, sga])


def conv_train_dw(x, w, g, scale, bias, a, b, pool_f: int) -> torch.Tensor:
    """x (B, Cin, F, T), w (3, 3, Cin, Cout), g (B, Cout, F/pf, T) in x's
    dtype, per-channel scale, bias, a, b -> (Cout * (kdim(Cin) + 2),) float32
    sums."""
    _check(x, w, pool_f)
    bsz, cin, f, t = x.shape
    cout = w.shape[3]
    if tuple(g.shape) != (bsz, cout, f // pool_f, t):
        raise ValueError(f"g must be {(bsz, cout, f // pool_f, t)}, got {tuple(g.shape)}")
    if not on_cuda(x, w, g, scale, bias, a, b):
        return conv_train_dw_plain(x, w, g, scale, bias, a, b, pool_f)
    code, lib = _launch_prelude(x, w, "conv_train_dw")
    require_contiguous(g=g)
    if g.dtype != x.dtype:
        raise TypeError(f"g is {g.dtype}, x is {x.dtype}")
    width = cout * (kdim(cin) + 2)
    partials = torch.empty((_grid_rows(x, pool_f), width), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty(width, dtype=torch.float32, device=x.device)
    cols = [_col(v) for v in (scale, bias, a, b)]
    err = lib.seld_conv3x3_train_dw(
        x.data_ptr(), w.data_ptr(), *[c.data_ptr() for c in cols], g.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), bsz, cin, f, t, cout, pool_f,
        TILES_PER_BLOCK, code, stream_handle(x.device))
    _build.check(err, "seld_conv3x3_train_dw")
    launch_counts["conv_train_dw"] += 1
    return sums


# ---- the op -----------------------------------------------------------------

def conv2d_bn_relu_fpool_train_plain(x, w, gamma, beta, pool_f: int, eps: float = 1e-5):
    """Plain version of the op, differentiated by torch autograd: the float
    conv, batch statistics (E[z^2] - E[z]^2), BN, ReLU, max-pool (gradient to
    the first max). x (B, F, T, Cin) -> (out (B, F/pf, T, Cout) in x's dtype,
    mean, var)."""
    z = _conv_plain(x.permute(0, 3, 1, 2), w)
    mean = z.mean((0, 2, 3))
    var = torch.clamp((z * z).mean((0, 2, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma.to(z.dtype) * inv
    y = z * scale[:, None, None] + (beta.to(z.dtype) - mean * scale)[:, None, None]
    out = F.max_pool2d(torch.relu(y), (pool_f, 1)).to(x.dtype)
    return out.permute(0, 2, 3, 1), mean.detach(), var.detach()


class _ConvTrainFn(torch.autograd.Function):
    """(x (B, Cin, F, T), w, gamma, beta) -> (out (B, Cout, F/pf, T), mean, var)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, pool_f, eps):
        cout = w.shape[3]
        n = x.shape[0] * x.shape[2] * x.shape[3]
        sums = conv_train_stats(x, w, pool_f)
        mean = sums[:cout] / n
        var = torch.clamp(sums[cout:] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma.to(inv.dtype) * inv
        bias = beta.to(inv.dtype) - mean * scale
        if on_cuda(x, w):   # F2: K2's smallcin kernel fed the batch-statistics affine
            out = conv2d_smallcin_bn_relu_fpool(x, w, _col(scale), _col(bias), pool_f)
        else:
            out = conv_train_fwd_plain(x, w, scale, bias, pool_f)
        ctx.save_for_backward(x, w, out, mean, inv, scale, bias)
        ctx.pool_f, ctx.n = pool_f, n
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        x, w, out, mean, inv, scale, bias = ctx.saved_tensors
        cout, n, cin = w.shape[3], ctx.n, x.shape[1]
        g = g_out.to(out.dtype).contiguous()
        # B1: the correction terms' sums, from the pooled output; a channel
        # with scale == 0 has no recoverable xhat and gets p = q = 0 (its
        # g_z correction is multiplied by scale == 0 anyway)
        zero = scale == 0
        safe = torch.where(zero, torch.ones_like(scale), scale)
        p = torch.where(zero, torch.zeros_like(scale), inv / safe)
        q = torch.where(zero, torch.zeros_like(scale), (bias / safe + mean) * inv)
        sel = sel_stats(out, g, p, q)
        c1, c2 = sel[:cout] / n, sel[cout:] / n
        a = inv * scale * c2
        b = scale * c1 - mean * a
        # B2: dW and the exact routed sums (dgamma, dbeta come from these)
        sums = conv_train_dw(x, w, g, scale, bias, a, b, ctx.pool_f)
        kd = kdim(cin)
        dw = sums[:cout * kd].view(cout, 3, 3, kd // 9)[..., :cin].permute(1, 2, 3, 0)
        sg, sga = sums[cout * kd:cout * (kd + 1)], sums[cout * (kd + 1):]
        dgamma = inv * (sga - mean * sg)
        g_dt, b_dt = ctx.param_dtypes
        return None, dw.to(w.dtype).contiguous(), dgamma.to(g_dt), sg.to(b_dt), None, None


def conv2d_bn_relu_fpool_train(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, pool_f: int, eps: float = 1e-5,
                               out_layout: str = "channel_last"):
    """x (B, F, T, Cin) with 3 * Cin <= 32, w (3, 3, Cin, Cout) in x's dtype,
    gamma / beta (Cout,) -> (out (B, F/pf, T, Cout) in x's dtype, mean
    (Cout,), var (Cout,)); pool_f <= :func:`max_pool_f` (Cin).

    Differentiable in w, gamma and beta (not x); mean and var are the biased
    batch statistics for the caller's running-average update. out is a
    channel-last view of the kernels' (B, Cout, F/pf, T) result, or that
    result itself with ``out_layout='CT'`` (the layout stages 2-3 take)."""
    if out_layout not in ("channel_last", "CT"):
        raise ValueError(f"out_layout {out_layout!r} not in ('channel_last', 'CT')")
    xc = x.permute(0, 3, 1, 2).contiguous()
    out, mean, var = _ConvTrainFn.apply(xc, w.contiguous(), gamma, beta, pool_f, eps)
    return (out if out_layout == "CT" else out.permute(0, 2, 3, 1)), mean, var
