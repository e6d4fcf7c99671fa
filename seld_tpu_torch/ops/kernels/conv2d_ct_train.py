"""Train-mode CNN stages 2-3 (K9): kernel wrappers, plain versions and the
autograd Function.

Counterpart of ``seld_tpu/ops/pallas/conv2d_ct_train.py::
conv2d_widecin_ct_bn_relu_fpool_train``: h (B, C, F, T) with C % 8 == 0, w
(3, 3, C, Cout), gamma / beta (Cout,) -> (out (B, Cout, F/pf, T) =
maxpool_f(relu(bn_batchstats(conv(h, w)))), mean, var), with the biased
batch statistics over N = B * F * T, and a backward for (h, w, gamma, beta):
stage 2 passes its gradient on to stage 1. The max-pool routes its gradient
to the first row holding the max, the ReLU to where the pre-activation is
> 0; g_z = scale * (g_pre - S_g/N - xhat * S_gx/N) is formed before any
product and rounded to the input dtype before both the dW and the dh
products; dgamma = S_gx, dbeta = S_g; the cotangents of mean and var (the
running statistics' inputs) are ignored.

Passes; each wrapper launches its kernel (``csrc/conv3x3_ct_train.cu``) for
CUDA tensors and runs its plain version for CPU tensors:

- F1 :func:`ct_train_stats` — the conv written once as ``pre`` (float), and
  its per-channel sum and sum of squares;
- (torch) mean, var, the BN affine;
- F2 — conv + affine + ReLU + frequency max-pool: on CUDA tensors
  ``conv2d_pool.conv2d_widecin_bn_relu_fpool`` (K3's
  ``seld_conv3x3_widecin`` whatever C is, its launches counted under that
  name) fed the batch-statistics affine; its conv rows equal ``pre`` bit for
  bit (one shared block tile: split TF32 in float32, ``mma.sync`` in
  bfloat16); on CPU tensors ``conv2d_train.conv_train_fwd_plain``;
- B1 :func:`ct_sel_stats` — S_g and S_gx, routed from ``pre``;
- B2 :func:`ct_gz` — g_z, written once in the input dtype, and
  :func:`ct_dw` — dW from g_z and h;
- B3 :func:`ct_dx` — dh, the transposed conv of g_z with w, on the block
  tile with the weights read flipped and transposed (split TF32 in float32,
  ``mma.sync`` in bfloat16).

B1 and B2 read ``pre`` where the TPU kernel recomputed the conv: on an 80 GB
card the float pre-activation of a flagship stage 2 at batch 8 (944 MB) is
cheaper to keep than a fourth and fifth conv. Both are bound by those bytes
and run one streaming walker (16-byte loads, a window's rows loaded before
use) on a persistent grid split by :func:`route_split`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)
from seld_tpu_torch.ops.kernels.conv2d_pool import (
    TC_BLOCK_T, TC_SLOTS, conv2d_widecin_bn_relu_fpool, tc_block_rows,
)
from seld_tpu_torch.ops.kernels.conv2d_train import conv_train_fwd_plain, dw_plain, dw_split

CIN_CHUNK = 8        # input channels the conv tile stages at a time (kCC)
GRID_MAX = 65535     # the grid's y and z range
# B1 and g_z: the streaming walker of csrc/conv3x3_ct_train.cu (route_walk)
ROUTE_QUAD = 4             # kQuad: frames a lane owns, one 16-byte load of a float row
ROUTE_WARPS = 8            # kRouteWarps: walkers (warps) a block
# the persistent grid's blocks an SM (kRouteStatsBlocks, kRouteGzBlocks: the
# kernels' __launch_bounds__, which hold B1 to 80 registers a thread, g_z to 128)
ROUTE_BLOCKS_PER_SM = {"stats": 3, "gz": 2}
H100_SMS = 132


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check(h, w, pool_f) -> None:
    if h.ndim != 4:
        raise ValueError(f"h must be (B, C, F, T), got {tuple(h.shape)}")
    c = h.shape[1]
    if c % CIN_CHUNK:
        raise ValueError(f"stages 2-3 take C % {CIN_CHUNK} == 0, got C={c}")
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Cout), got {tuple(w.shape)}")
    if pool_f < 1 or h.shape[2] % pool_f:
        raise ValueError(f"F={h.shape[2]} must divide into pool_f={pool_f} rows")


def _check_rows(pre, g, cols, pool_f) -> None:
    b, cout, f, t = pre.shape
    if pool_f < 1 or f % pool_f:
        raise ValueError(f"F={f} must divide into pool_f={pool_f} rows")
    if tuple(g.shape) != (b, cout, f // pool_f, t):
        raise ValueError(f"g must be {(b, cout, f // pool_f, t)}, got {tuple(g.shape)}")
    if tuple(cols.shape) != (6, cout):
        raise ValueError(f"cols must be (6, {cout}), got {tuple(cols.shape)}")


def _conv_plain(h, w) -> torch.Tensor:
    """The conv in float32 (float64 for float64 input) on the input's values:
    (B, Cout, F, T), as the kernels accumulate it."""
    cdt = _acc_dtype(h)
    return F.conv2d(h.to(cdt), w.to(cdt).permute(3, 2, 0, 1), padding=1)


def _launch_prelude(x, w, name):
    require_contiguous(x=x, w=w)
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w is {w.dtype}, input is {x.dtype}")
    return dtype_code(x), _build.load()


def _rows_prelude(pre, g, cols, name):
    require_contiguous(pre=pre, g=g, cols=cols)
    if pre.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError(f"{name}: pre and cols must be float32")
    return dtype_code(g), _build.load()


@functools.lru_cache(maxsize=256)   # on every launch's host path: ~17 us a search
def route_split(b: int, cout: int, f_out: int, t: int, sms: int = H100_SMS,
                blocks_per_sm: int = ROUTE_BLOCKS_PER_SM["stats"]) -> tuple[int, int, int]:
    """(frames_per_span, spans, blocks) of B1's or g_z's walker (``blocks_per_sm``
    its kernel's resident blocks, :data:`ROUTE_BLOCKS_PER_SM`). Its work
    units are (b, channel, pooled row, frame span), B * Cout * F' * spans of
    them, unit u = window * spans + span with window = (b * Cout + channel)
    * F' + pooled row; span s holds frames [s * frames_per_span, min(T, (s +
    1) * frames_per_span)). ``blocks`` (at most ``sms`` x ``blocks_per_sm``,
    all resident at once) x ROUTE_WARPS warps walk them, each warp taking u
    = warp * blocks + block, then every ROUTE_WARPS x blocks-th unit after,
    and each lane one quad of 4 frames in 32. The span is the one whose
    longest walk is shortest: the units' rounds over the warps, times the
    quads a lane takes in a unit plus one for the unit's set-up and sums.
    For B1 at batch 2 that is one whole round at stage 2 (1536 windows, 2
    spans) and at stage 3 (768 windows, 4 spans) on 132 SMs. B1's partials have B * F' * spans rows,
    row (b * F' + pooled row) * spans + span."""
    warps = sms * blocks_per_sm * ROUTE_WARPS
    windows = b * cout * f_out
    quads = -(-t // ROUTE_QUAD)
    best = None
    for want in range(1, max(1, quads // 32) + 1):   # at least a quad a lane, but for T < 128
        span_quads = -(-quads // want)
        spans = -(-quads // span_quads)
        walk = -(-(windows * spans) // warps) * (-(-span_quads // 32) + 1)
        if best is None or walk < best[0]:
            best = (walk, span_quads, spans)
    _, span_quads, spans = best
    blocks = min(-(-(windows * spans) // ROUTE_WARPS), sms * blocks_per_sm)
    return ROUTE_QUAD * span_quads, spans, blocks


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _route_launch(pre, pool_f, kernel):
    """(frames_per_span, spans, blocks) of a launch of ``kernel`` ('stats' or
    'gz') on pre's card."""
    b, cout, f, t = pre.shape
    return route_split(b, cout, f // pool_f, t, _sms(pre.device), ROUTE_BLOCKS_PER_SM[kernel])


# ---- F1: the conv, once, and its batch statistics ----------------------------

def ct_train_stats_plain(h, w):
    """(sums (2 * Cout,) = [sum | sum of squares] over (B, F, T), pre (B,
    Cout, F, T)) of the float conv."""
    pre = _conv_plain(h, w)
    return torch.cat([pre.sum((0, 2, 3)), (pre * pre).sum((0, 2, 3))]), pre


def ct_train_stats(h: torch.Tensor, w: torch.Tensor, pool_f: int):
    """h (B, C, F, T), w (3, 3, C, Cout) -> (sums (2 * Cout,) float32, pre
    (B, Cout, F, T) float32). ``pool_f`` sets the kernel's tiling as F2's:
    the block tile's ``tc_block_rows(pool_f)`` rows a block (bfloat16 on
    ``mma.sync``, float32 in split TF32)."""
    _check(h, w, pool_f)
    if not on_cuda(h, w):
        return ct_train_stats_plain(h, w)
    code, lib = _launch_prelude(h, w, "ct_train_stats")
    b, c, f, t = h.shape
    cout = w.shape[3]
    if b * (f // pool_f) > GRID_MAX:
        raise ValueError("B * F / pool_f exceeds the grid's z range")
    pre = torch.empty((b, cout, f, t), dtype=torch.float32, device=h.device)
    rows = b * -(-f // tc_block_rows(pool_f)) * -(-t // TC_BLOCK_T)   # the block tile's grid
    partials = torch.empty((rows, 2 * cout), dtype=torch.float32, device=h.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=h.device)
    err = lib.seld_ct_train_stats(
        h.data_ptr(), w.data_ptr(), pre.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        b, c, f, t, cout, pool_f, code, stream_handle(h.device))
    _build.check(err, "seld_ct_train_stats")
    launch_counts["ct_train_stats"] += 1
    return sums, pre


# ---- B1, B2: routing from pre ------------------------------------------------

def _route_plain(pre, g, cols, pool_f):
    """(g_pre, xhat), both (B, Cout, F, T): g routed to the first row of each
    pool window holding the max of relu(pre * scale + bias), where that max
    is > 0; xhat = (pre - mean) * inv. A window holding a NaN has a NaN max
    (``torch.max`` propagates it), so it routes nothing, as JAX's
    ``_route_group`` and the kernels' ``route_first_max``."""
    b, cout, f, t = pre.shape
    col = lambda i: cols[i].to(pre.dtype)[:, None, None]
    y = torch.relu(pre * col(0) + col(1)).view(b, cout, f // pool_f, pool_f, t)
    m, idx = y.max(dim=3)                                          # first max
    zero = torch.zeros((), dtype=pre.dtype, device=pre.device)
    gsel = torch.where(m > 0, g.to(pre.dtype), zero)
    g_pre = torch.zeros_like(y).scatter_(3, idx.unsqueeze(3), gsel.unsqueeze(3))
    return g_pre.view(b, cout, f, t), (pre - col(2)) * col(3)


def ct_sel_stats_plain(pre, g, cols, pool_f: int) -> torch.Tensor:
    """(2 * Cout,) = [S_g | S_gx] = [sum g_pre | sum g_pre * xhat]."""
    g_pre, xhat = _route_plain(pre, g, cols, pool_f)
    return torch.cat([g_pre.sum((0, 2, 3)), (g_pre * xhat).sum((0, 2, 3))])


def ct_sel_stats(pre: torch.Tensor, g: torch.Tensor, cols: torch.Tensor,
                 pool_f: int) -> torch.Tensor:
    """pre (B, Cout, F, T) float, g (B, Cout, F/pf, T), cols (6, Cout) float
    (rows scale, bias, mean, inv; rows 4-5 unused) -> (2 * Cout,) float.
    CUDA tensors launch ``ct_route_stats_kernel``: the streaming walker of
    :func:`route_split`'s units, one partial row per (b, pooled row, span),
    reduced in a fixed order (a rerun is bitwise equal)."""
    _check_rows(pre, g, cols, pool_f)
    if not on_cuda(pre, g, cols):
        return ct_sel_stats_plain(pre, g, cols, pool_f)
    code, lib = _rows_prelude(pre, g, cols, "ct_sel_stats")
    b, cout, f, t = pre.shape
    frames_per_span, spans, blocks = _route_launch(pre, pool_f, "stats")
    partials = torch.empty((b * (f // pool_f) * spans, 2 * cout), dtype=torch.float32,
                           device=pre.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=pre.device)
    err = lib.seld_ct_train_sel_stats(
        pre.data_ptr(), g.data_ptr(), cols.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        b, cout, f, t, pool_f, frames_per_span, blocks, code, stream_handle(pre.device))
    _build.check(err, "seld_ct_train_sel_stats")
    launch_counts["ct_train_sel_stats"] += 1
    return sums


def ct_gz_plain(pre, g, cols, pool_f: int) -> torch.Tensor:
    """g_z = scale * (g_pre - c1 - xhat * c2) (B, Cout, F, T), rounded to g's
    dtype."""
    g_pre, xhat = _route_plain(pre, g, cols, pool_f)
    col = lambda i: cols[i].to(pre.dtype)[:, None, None]
    return (col(0) * (g_pre - col(4) - xhat * col(5))).to(g.dtype)


def ct_gz(pre: torch.Tensor, g: torch.Tensor, cols: torch.Tensor, pool_f: int) -> torch.Tensor:
    """pre, g as for :func:`ct_sel_stats`; cols (6, Cout): scale, bias, mean,
    inv, c1 = S_g / N, c2 = S_gx / N -> g_z (B, Cout, F, T) in g's dtype.
    CUDA tensors launch ``ct_route_gz_kernel``, B1's walker split for its
    own grid, which routes from the rows it holds and writes each once (pre
    read once at pf <= 8)."""
    _check_rows(pre, g, cols, pool_f)
    if not on_cuda(pre, g, cols):
        return ct_gz_plain(pre, g, cols, pool_f)
    code, lib = _rows_prelude(pre, g, cols, "ct_gz")
    b, cout, f, t = pre.shape
    frames_per_span, _, blocks = _route_launch(pre, pool_f, "gz")
    gz = torch.empty(pre.shape, dtype=g.dtype, device=pre.device)
    err = lib.seld_ct_train_gz(pre.data_ptr(), g.data_ptr(), cols.data_ptr(), gz.data_ptr(),
                               b, cout, f, t, pool_f, frames_per_span, blocks, code,
                               stream_handle(pre.device))
    _build.check(err, "seld_ct_train_gz")
    launch_counts["ct_train_gz"] += 1
    return gz


# ---- B2: dW; B3: dh ------------------------------------------------------------

def ct_dw(h: torch.Tensor, gz: torch.Tensor) -> torch.Tensor:
    """h (B, C, F, T), gz (B, Cout, F, T) of one dtype -> dW (3, 3, C, Cout)
    float32: the dW tile of ``csrc/conv3x3_dw_tc.cuh`` in bfloat16, the
    split-TF32 tile of ``csrc/conv3x3_dw_tf32.cuh`` in float32, each block a
    share of the depth (:func:`conv2d_train.dw_split`) reduced in a fixed
    order."""
    if h.ndim != 4 or gz.ndim != 4 or h.shape[0] != gz.shape[0] or h.shape[2:] != gz.shape[2:]:
        raise ValueError(f"h {tuple(h.shape)} and gz {tuple(gz.shape)} must be (B, *, F, T) "
                         "of one B, F and T")
    if h.shape[1] % CIN_CHUNK:
        raise ValueError(f"stages 2-3 take C % {CIN_CHUNK} == 0, got C={h.shape[1]}")
    if not on_cuda(h, gz):
        return dw_plain(h, gz)
    code, lib = _launch_prelude(h, gz, "ct_dw")
    b, c, f, t = h.shape
    cout = gz.shape[1]
    rows_per_split, frames_per_split, splits = dw_split(b, f, t)
    partials = torch.empty((splits, 9 * c * cout), dtype=torch.float32, device=h.device)
    dw = torch.empty((3, 3, c, cout), dtype=torch.float32, device=h.device)
    err = lib.seld_ct_train_dw(h.data_ptr(), gz.data_ptr(), partials.data_ptr(), dw.data_ptr(),
                               b, c, f, t, cout, rows_per_split, frames_per_split, code,
                               stream_handle(h.device))
    _build.check(err, "seld_ct_train_dw")
    launch_counts["ct_train_dw"] += 1
    return dw


def ct_dx_plain(gz, w) -> torch.Tensor:
    """dh (B, C, F, T) in gz's dtype: the input gradient of the conv with
    weights w at output gradient gz, in float."""
    cdt = _acc_dtype(gz)
    b, _, f, t = gz.shape
    dh = torch.nn.grad.conv2d_input((b, w.shape[2], f, t), w.to(cdt).permute(3, 2, 0, 1),
                                    gz.to(cdt), padding=1)
    return dh.to(gz.dtype)


def ct_dx(gz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """gz (B, Cout, F, T), w (3, 3, C, Cout) of one dtype -> dh (B, C, F, T)
    in that dtype: the block tile on the transposed weights (``FtPipe<true>``
    in float32, ``TbPipe<true>`` in bfloat16), 64 channels x 64 frames x 4
    rows a block."""
    if gz.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[3] != gz.shape[1]:
        raise ValueError(f"gz {tuple(gz.shape)} and w {tuple(w.shape)} must be (B, Cout, F, T) "
                         "and (3, 3, C, Cout)")
    if not on_cuda(gz, w):
        return ct_dx_plain(gz, w)
    code, lib = _launch_prelude(gz, w, "ct_dx")
    b, cout, f, t = gz.shape
    c = w.shape[2]
    if b * -(-f // TC_SLOTS) > GRID_MAX:
        raise ValueError("B * F / 4 exceeds the grid's z range")
    dh = torch.empty((b, c, f, t), dtype=gz.dtype, device=gz.device)
    err = lib.seld_ct_train_dx(gz.data_ptr(), w.data_ptr(), dh.data_ptr(), b, c, f, t, cout,
                               code, stream_handle(gz.device))
    _build.check(err, "seld_ct_train_dx")
    launch_counts["ct_train_dx"] += 1
    return dh


# ---- the op ---------------------------------------------------------------------

def conv2d_ct_bn_relu_fpool_train_plain(h, w, gamma, beta, pool_f: int, eps: float = 1e-5):
    """Plain version of the op, differentiated by torch autograd: the float
    conv, batch statistics (E[z^2] - E[z]^2), BN, ReLU, max-pool (gradient to
    the first max). h (B, C, F, T) -> (out (B, Cout, F/pf, T) in h's dtype,
    mean, var)."""
    z = _conv_plain(h, w)
    mean = z.mean((0, 2, 3))
    var = torch.clamp((z * z).mean((0, 2, 3)) - mean * mean, min=0.0)
    scale = gamma.to(z.dtype) * torch.rsqrt(var + eps)
    y = z * scale[:, None, None] + (beta.to(z.dtype) - mean * scale)[:, None, None]
    out = F.max_pool2d(torch.relu(y), (pool_f, 1)).to(h.dtype)
    return out, mean.detach(), var.detach()


class _ConvCTTrainFn(torch.autograd.Function):
    """(h (B, C, F, T), w, gamma, beta) -> (out (B, Cout, F/pf, T), mean, var).
    With a ``cross_rank`` hook (data parallelism) F1's and B1's sums are summed
    over the ranks between the passes, and n counts every rank's rows."""

    @staticmethod
    def forward(ctx, h, w, gamma, beta, pool_f, eps, cross_rank):
        cout = w.shape[3]
        n = h.shape[0] * h.shape[2] * h.shape[3]
        sums, pre = ct_train_stats(h, w, pool_f)
        if cross_rank is not None:   # the statistics formed once, from every rank's sums
            sums = cross_rank.sum(sums, "K9 F1")
            n *= cross_rank.world
        mean = sums[:cout] / n
        var = torch.clamp(sums[cout:] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma.to(inv.dtype) * inv
        bias = beta.to(inv.dtype) - mean * scale
        if on_cuda(h, w):   # F2: K3's widecin kernel fed the batch-statistics affine
            out = conv2d_widecin_bn_relu_fpool(h, w, scale.contiguous(), bias.contiguous(),
                                               pool_f)
        else:
            out = conv_train_fwd_plain(h, w, scale, bias, pool_f)
        ctx.save_for_backward(h, w, pre, mean, inv, scale, bias)
        ctx.pool_f, ctx.n, ctx.cross_rank = pool_f, n, cross_rank
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        h, w, pre, mean, inv, scale, bias = ctx.saved_tensors
        cout, n, pf = w.shape[3], ctx.n, ctx.pool_f
        g = g_out.to(h.dtype).contiguous()
        zero = torch.zeros_like(scale)
        sel = ct_sel_stats(pre, g, torch.stack([scale, bias, mean, inv, zero, zero]), pf)
        sg, sgx = sel[:cout], sel[cout:]   # dbeta, dgamma: this rank's share
        # g_z's correction terms: the global batch's sums
        tot = ctx.cross_rank.sum(sel, "K9 B1") if ctx.cross_rank is not None else sel
        gz = ct_gz(pre, g, torch.stack([scale, bias, mean, inv, tot[:cout] / n,
                                        tot[cout:] / n]), pf)
        dw = ct_dw(h, gz)
        dh = ct_dx(gz, w) if ctx.needs_input_grad[0] else None
        g_dt, b_dt = ctx.param_dtypes
        return dh, dw.to(w.dtype), sgx.to(g_dt), sg.to(b_dt), None, None, None


def conv2d_ct_bn_relu_fpool_train(h: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, pool_f: int, eps: float = 1e-5,
                                  cross_rank=None):
    """h (B, C, F, T) with C % 8 == 0, w (3, 3, C, Cout) in h's dtype,
    gamma / beta (Cout,) -> (out (B, Cout, F/pf, T) in h's dtype, mean
    (Cout,), var (Cout,)).

    Differentiable in h, w, gamma and beta; mean and var are the biased
    batch statistics for the caller's running-average update. ``cross_rank``
    (``parallel/cross_rank.py``): h is this rank's rows of a global batch, and
    the statistics are the global batch's; dh, dW, dgamma and dbeta stay this
    rank's share of the gradient of the ranks' summed losses."""
    _check(h, w, pool_f)
    return _ConvCTTrainFn.apply(h.contiguous(), w.contiguous(), gamma, beta, pool_f, eps,
                                cross_rank)
