"""The split-TF32 arithmetic of the float32 tensor-core kernels (K4's
``flash_fwd_tf32_kernel`` and ``flash_fwd_wide_tf32_kernel``, K6's
``flash_dq_tf32_kernel`` / ``flash_dkv_tf32_kernel`` and their wide
counterparts past head dim 128, K7's ``hamilton_tf32_kernel``, the dW tile
``ct_dw_tf32_kernel`` of K9 and K5, the conv-pool GEMM tile of K2w and
K10a, ``smallcin_wide_tf32_kernel`` / ``im2col_tf32_kernel``, and the conv
block tile of K3, K10b and K9's F1 / F2 / dh, ``conv3x3_tf32_kernel`` /
``ct_stats_tf32_kernel`` / ``ct_dx_tf32_kernel``; helpers in
``csrc/mma.cuh``), in plain PyTorch for the tests: no wrapper calls it.

A float32 x is split as x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
tf32 rounding as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, the low 13 of the 23 fraction bits zero). A product a b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 products, each exact in
float64 (two TF32 values' product has 22 significant bits); the kernels add
them on float accumulators, each k8 step's three from zero, then the step's
partial into the float accumulator rounded to nearest (``mma_3xtf32_add``).
:func:`hamilton_matmul_tf32_plain`, :func:`flash_attention_tf32_plain` and
:func:`flash_attention_bwd_tf32_plain` repeat K7's, K4's and K6's arithmetic
so: each step's partial summed in float64 and rounded once to float32 (the
tensor cores sum a step's products in their own order and truncate, which
the card's tests hold to float64).
:func:`smallcin_wide_product_tf32_plain` and :func:`im2col_product_tf32_plain`
repeat K2w's and K10a's products so, in K order (K2w's over the pack rows
it walks), before the plain epilogue; :func:`conv_rows_tf32_plain`,
:func:`conv_pool_tf32_plain` and :func:`ct_dx_tf32_plain` the block tile's,
in its K walk (chunks of 8 channels, the nine taps in each).
:func:`conv_dw_tf32_plain` repeats the dW tile's, whose two levels are a
64-frame step (eight k8 steps) and the block's float accumulator, and
whose blocks' partial rows are summed in float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch.ops.hamilton import assemble_hamilton
from seld_tpu_torch.ops.kernels.attention import head_dim_plan, pad_heads
from seld_tpu_torch.ops.kernels.conv2d_pool import _epilogue
from seld_tpu_torch.ops.kernels.conv2d_train import DW_FRAME_STEP, DW_SPLITS_STAGE1, dw_split

_LOW = 0x1FFF         # the 13 fraction bits TF32 drops
_HALF = 0x1000        # half a TF32 ulp in them
_MAG = 0x7FFFFFFF
_EXP = 0x7F800000


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(bits: torch.Tensor, shape) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32).view(shape)


def tf32_add_half_and_mask(x: torch.Tensor) -> torch.Tensor:
    """The kernels' cheap rounding of lo: half a TF32 ulp added to the bits,
    the low 13 bits cleared, with no test for non-finite values. For finite x
    it is :func:`tf32_round_plain`'s result; a NaN whose fraction's top ten
    bits are ones (0x7fffffff) carries into the sign and comes out a zero,
    which is why hi is not taken this way."""
    return _float((_bits(x) + _HALF) & ~_LOW & 0xFFFFFFFF, x.shape)


def tf32_round_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` (the kernels' hi):
    the magnitude's bits plus half a TF32 ulp, the low 13 bits then cleared
    (ties away from zero; a carry moves into the exponent); infinities and
    NaNs as they are."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round_plain takes float32, got {x.dtype}")
    bits = _bits(x)
    sign, mag = bits & 0x80000000, bits & _MAG
    rounded = torch.where((mag & _EXP) == _EXP, mag, (mag + _HALF) & ~_LOW & 0xFFFFFFFF)
    return _float(sign | rounded, x.shape)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of ``split_tf32``: hi = tf32(x) as :func:`tf32_round_plain`,
    lo = :func:`tf32_add_half_and_mask` of x - hi; both float32 with their
    low 13 fraction bits zero. For a non-finite x, hi is a NaN or the
    infinity, lo a NaN or a zero."""
    hi = tf32_round_plain(x)
    return hi, tf32_add_half_and_mask(x - hi)


def _split_products(a_hi, a_lo, b_hi, b_lo, acc=None) -> torch.Tensor:
    """acc + the sum over k8 steps of (a_lo b_hi + a_hi b_lo + a_hi b_hi)[step]
    (a (..., K), b (..., K, N)), each step's three products in float64 rounded
    once to float32 and added to the float32 accumulator in order."""
    for k0 in range(0, a_hi.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        step = sum(x[..., sl].double() @ y[..., sl, :].double()
                   for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))).float()
        acc = step if acc is None else acc + step
    return acc


def hamilton_matmul_tf32_plain(x2d: torch.Tensor, comps: torch.Tensor, bias, n_comp: int,
                               linear_table: bool) -> torch.Tensor:
    """K7's float32 arithmetic (``hamilton_tf32_kernel``): x and the
    assembled weight (signs exact) split into hi + lo, x (M, n cin) times
    the weight in k8 steps of three products, then the bias added in
    float32; ``hamilton_matmul_plain``'s contract."""
    w = assemble_hamilton(comps, linear_table)
    (xh, xl), (wh, wl) = tf32_split_plain(x2d), tf32_split_plain(w)
    out = _split_products(xh, xl, wh, wl)
    return out if bias is None else out + bias


def smallcin_wide_product_tf32_plain(p0: torch.Tensor, wk: torch.Tensor, scale, bias,
                                     pool_f: int, t: int, rows: int) -> torch.Tensor:
    """K2w's float32 arithmetic (``smallcin_wide_tf32_kernel<ROWS>``) on a
    float32 pack p0 (B, F + 2, kg, tpad) and wk (Cout, 3 kg): per conv row,
    the first ``rows`` rows of each kg group of pack rows f .. f + 2 (the
    kernel's walk: ``conv2d_pool.smallcin_rows``, or all kg) and wk's
    matching columns split into hi + lo, then k8 steps of three products in
    (dy, row) order; the plain epilogue; frames >= t dropped.
    ``smallcin_wide_product_plain``'s contract."""
    f, kg = p0.shape[1] - 2, p0.shape[2]
    stack = torch.cat([p0[:, dy:dy + f, :rows, :t] for dy in range(3)], dim=2).contiguous()
    wr = torch.cat([wk[:, dy * kg:dy * kg + rows] for dy in range(3)], dim=1).contiguous()
    (xh, xl), (wh, wl) = tf32_split_plain(stack), tf32_split_plain(wr)
    y = _split_products(wh, wl, xh, xl)                         # (B, F, Cout, T)
    return _epilogue(y.transpose(1, 2), scale, bias, pool_f, p0.dtype).contiguous()


def im2col_product_tf32_plain(patches: torch.Tensor, wk: torch.Tensor, scale, bias,
                              pool_f: int) -> torch.Tensor:
    """K10a's float32 arithmetic (``im2col_tf32_kernel``) on float32 patches
    (B, F, T, K) and wk (K, Cout): both split into hi + lo, k8 steps of three
    products over K in order (the kernel's 32-deep chunks feed the same
    accumulators), then the plain epilogue. ``im2col_product_plain``'s
    contract."""
    (ph, pl), (wh, wl) = tf32_split_plain(patches), tf32_split_plain(wk.contiguous())
    y = _split_products(ph, pl, wh, wl)                         # (B, F, T, Cout)
    return _epilogue(y.permute(0, 3, 1, 2), scale, bias, pool_f, patches.dtype).contiguous()


CONV_CHUNK = 8   # input channels per K chunk of the float conv block tile (kFtCc)


def conv_rows_tf32_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float conv block tile's conv rows (``FtPipe`` of
    ``csrc/conv3x3_tf32.cuh``: K9's F1 writes them as ``pre``, K3 / K10b /
    K9's F2 pool them) on float32 x (B, Cin, F, T) and w (3, 3, Cin, Cout)
    -> (B, Cout, F, T) float32: x (zero-padded by one frame and one row, its
    channels to a multiple of 8) and w split into hi + lo; per chunk of 8
    channels in increasing order and per tap (dy, dx) in row-major order, one
    k8 step of three products summed in float64 and rounded once, added to a
    float32 accumulator that starts at zero."""
    b, cin, f, t = x.shape
    cp = -(-cin // CONV_CHUNK) * CONV_CHUNK
    (xh, xl) = tf32_split_plain(F.pad(x, (1, 1, 1, 1, 0, cp - cin)).contiguous())
    (wh, wl) = tf32_split_plain(F.pad(w, (0, 0, 0, cp - cin)).contiguous())
    acc = None
    for c0 in range(0, cp, CONV_CHUNK):
        ch = slice(c0, c0 + CONV_CHUNK)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            step = sum(torch.einsum("bcft,co->boft", u[:, ch, dy:dy + f, dx:dx + t].double(),
                                    v[dy, dx, ch].double())
                       for u, v in ((xh, wl), (xl, wh), (xh, wh))).float()
            acc = step if acc is None else acc + step
    return acc


def conv_pool_tf32_plain(x: torch.Tensor, w: torch.Tensor, scale, bias,
                         pool_f: int) -> torch.Tensor:
    """K3's, K10b's and K9's F2 float32 arithmetic (``conv3x3_tf32_kernel``):
    :func:`conv_rows_tf32_plain`, then the plain epilogue (affine, ReLU,
    max over pool_f rows). ``conv2d_bn_relu_fpool_plain``'s contract."""
    return _epilogue(conv_rows_tf32_plain(x, w), scale, bias, pool_f, x.dtype).contiguous()


def ct_dx_tf32_plain(gz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K9's float32 dh arithmetic (``ct_dx_tf32_kernel``, the block tile on
    the transposed weights) on gz (B, Cout, F, T) and w (3, 3, Cin, Cout)
    float32 -> (B, Cin, F, T) float32: :func:`conv_rows_tf32_plain` of gz
    with w flipped in both taps and its channels swapped (tap (dy, dx) takes
    w[2 - dy][2 - dx] transposed), so the K walk is gz's channels in chunks
    of 8, the nine taps in each. ``conv2d_ct_train.ct_dx_plain``'s
    contract."""
    return conv_rows_tf32_plain(gz, w.flip(0, 1).transpose(2, 3))


def _heads_first(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(B, T, H, D) -> contiguous (B, H, T, D)."""
    return tuple(a.permute(0, 2, 1, 3).contiguous() for a in tensors)


def flash_attention_tf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                               tile: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's float32 arithmetic (``flash_fwd_tf32_kernel`` at D <= 128,
    ``flash_fwd_wide_tf32_kernel`` past it) on q, k, v (B, T, H, D) float32,
    at the padded D and column groups of ``attention.head_dim_plan``: per
    column group and tile of ``tile`` keys, S = Q K^T in k8 steps of three
    products over all of the padded D (so once per group); the online
    softmax in float32 (the running max of the scaled scores, p = exp(s *
    scale - m) with s * scale - m rounded once as the kernel's fma, the row
    sums in float32); O += P V over the group's columns in k8 steps of three
    products over the tile's keys; then out = O * (1 / l), lse = m + log l
    (the first group's). ``flash_attention_plain``'s contract: (out (B, T,
    H, D), lse (B, H, T))."""
    d_true = q.shape[-1]
    d_pad, width = head_dim_plan(d_true, q.dtype)
    qt, kt, vt = _heads_first(*pad_heads(d_pad, q, k, v))   # (B, H, T, d_pad)
    qh, ql = tf32_split_plain(qt)
    b, h, t, _ = qt.shape
    outs, lse = [], None
    for g0 in range(0, d_pad, width):   # one block's columns of out
        m = torch.full((b, h, t), -float("inf"))
        l = torch.zeros((b, h, t))
        o = torch.zeros((b, h, t, min(width, d_pad - g0)))
        for j0 in range(0, t, tile):
            kh, kl = tf32_split_plain(kt[:, :, j0:j0 + tile].contiguous())
            vh, vl = tf32_split_plain(vt[:, :, j0:j0 + tile, g0:g0 + width].contiguous())
            s = _split_products(qh, ql, kh.transpose(-1, -2), kl.transpose(-1, -2))
            m_new = torch.maximum(m, s.max(-1).values * scale)
            alpha = torch.exp(m - m_new)
            p = torch.exp((s.double() * scale - m_new.double()[..., None]).float())
            l = l * alpha + p.sum(-1)
            ph, pl = tf32_split_plain(p)
            o = _split_products(ph, pl, vh, vl, o * alpha[..., None])
            m = m_new
        outs.append(o * (1.0 / l)[..., None])
        lse = m + torch.log(l) if lse is None else lse
    out = torch.cat(outs, -1)[..., :d_true]
    return out.permute(0, 2, 1, 3).contiguous(), lse


def flash_attention_bwd_tf32_plain(q, k, v, out, dout, lse, scale: float):
    """K6's float32 arithmetic (``flash_dq_tf32_kernel`` /
    ``flash_dkv_tf32_kernel`` at D <= 128, ``flash_dq_wide_tf32_kernel`` /
    ``flash_dkv_wide_tf32_kernel`` past it) on float32 (B, T, H, D) operands
    and lse (B, H, T), at the padded D of ``attention.head_dim_plan``: delta
    = rowsum(dout * out) in float32; S = Q K^T and dP = dO V^T in k8 steps of
    three products over all of the padded D; P = exp(S * scale - lse), the
    argument rounded once (the kernels' fma); dS = P (dP - delta) in
    float32; dQ = dS K, dK = dS^T Q and dV = P^T dO in k8 steps of three
    products over the keys (queries), each step's partial added to the
    float32 accumulator in order; dq and dk times the scale.
    ``flash_attention_bwd_plain``'s contract: (dq, dk, dv). Every column
    group's block computes the same S and dP, and a gradient column's sums
    do not depend on the others, so the groups change no value here and all
    columns are taken at once."""
    d_true = q.shape[-1]
    d_pad, _ = head_dim_plan(d_true, q.dtype)
    qt, kt, vt, ot, dot = _heads_first(*pad_heads(d_pad, q, k, v, out, dout))
    delta = (dot * ot).sum(-1)                                   # (B, H, T)
    (qh, ql), (kh, kl), (vh, vl), (dh, dl) = (tf32_split_plain(a) for a in (qt, kt, vt, dot))
    tr = lambda a: a.transpose(-1, -2).contiguous()
    s = _split_products(qh, ql, tr(kh), tr(kl))
    dp = _split_products(dh, dl, tr(vh), tr(vl))
    p = torch.exp((s.double() * scale - lse.double()[..., None]).float())
    ds = p * (dp - delta[..., None])
    (ph, pl), (sh, sl) = tf32_split_plain(tr(p)), tf32_split_plain(ds)
    dq = _split_products(sh, sl, kh, kl) * scale
    dk = _split_products(*tf32_split_plain(tr(ds)), qh, ql) * scale
    dv = _split_products(ph, pl, dh, dl)
    return tuple(g[..., :d_true].permute(0, 2, 1, 3).contiguous() for g in (dq, dk, dv))


def conv_dw_tf32_plain(x: torch.Tensor, gz: torch.Tensor) -> torch.Tensor:
    """The float32 dW tile's arithmetic (``ct_dw_tf32_kernel``) on x (B, Cin,
    F, T) and gz (B, Cout, F, T) float32 -> dW (3, 3, Cin, Cout), as
    ``conv2d_train.dw_plain`` contracts it: x and gz split into hi + lo;
    per (b, f) row and 64-frame step, the three products summed over the
    step (in float64, rounded once to float32: the tensor cores' chain from
    zero); each block's share of the depth (:func:`conv2d_train.dw_split`
    over K5's DW_SPLITS_STAGE1) adds its steps to a float32 accumulator,
    rows then steps in order; the shares are summed in float64 and rounded
    once (``launch_reduce``)."""
    b, cin, f, t = x.shape
    cout = gz.shape[1]
    step = DW_FRAME_STEP
    steps = -(-t // step)
    tp = steps * step
    gh, gl = (a.double().view(b, cout, f, steps, step)
              for a in tf32_split_plain(F.pad(gz, (0, tp - t)).contiguous()))
    xh, xl = tf32_split_plain(F.pad(x, (1, 1 + tp - t, 1, 1)).contiguous())
    parts = torch.empty(b, f, steps, 9, cin, cout)   # each step's partial, float32
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        ah, al = (a[:, :, dy:dy + f, dx:dx + tp].double().reshape(b, cin, f, steps, step)
                  for a in (xh, xl))
        prod = sum(torch.einsum("bcfsk,bofsk->bfsco", u, v)
                   for u, v in ((al, gh), (ah, gl), (ah, gh)))
        parts[:, :, :, tap] = prod.float()
    # the blocks' shares: rows_per_split rows x spf steps each, in that order
    rows_per_split, frames_per_split, _ = dw_split(b, f, t, DW_SPLITS_STAGE1)
    spf = steps if frames_per_split >= t else frames_per_split // step
    rows, row_splits, frame_splits = b * f, -(-(b * f) // rows_per_split), -(-steps // spf)
    width = 9 * cin * cout
    p = torch.zeros(row_splits * rows_per_split, frame_splits * spf, width)
    p[:rows, :steps] = parts.view(rows, steps, width)
    p = p.view(row_splits, rows_per_split, frame_splits, spf, width)
    acc = torch.zeros(row_splits, frame_splits, width)
    for k in range(rows_per_split):
        for j in range(spf):
            acc = acc + p[:, k, :, j]
    return acc.double().sum((0, 1)).float().view(3, 3, cin, cout)
