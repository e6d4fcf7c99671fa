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

The passes, each a wrapper that launches its kernel (``csrc/conv3x3_train.cu``)
for CUDA tensors and runs its plain version for CPU tensors. Which kernels
F1 and F2 run depends on the dtype alone (:func:`tensor_core_path`); B2 is
the same two passes in both dtypes:

- F1 :func:`conv_train_stats` — per-channel sum and sum of squares of the conv;
- (torch) mean, var, the BN affine;
- F2 — conv + affine + ReLU + frequency max-pool, fed the batch-statistics
  affine: in float32 K2's ``seld_conv3x3_smallcin``
  (``conv2d_pool.conv2d_smallcin_bn_relu_fpool``, counted under that name),
  in bfloat16 K3's tensor-core tile through K10b's entry
  (``conv2d_pool.conv2d_windows_bn_relu_fpool``, counted as
  ``conv3x3_windows``); on CPU tensors :func:`conv_train_fwd_plain`;
- B1 :func:`sel_stats` — S_g, S_gx from (out, cotangent) where out > 0;
- B2 — dW, and the exact routed S_g and sum g * acc that give dgamma and
  dbeta, in two passes as K9's: :func:`conv_train_gz` (one recompute of the
  conv that routes g and writes g_z once: the float smallcin tile in
  float32, the conv tile in bfloat16) and :func:`conv_train_dw_gz` (the dW
  tile, a GEMM over the frames: split-TF32 products in float32, bf16
  products in bfloat16).

One K walk per dtype serves F1, F2 and B2's recompute, so B2's routing
recomputes F2's pooled rows bit for bit: in float32 the float smallcin tile
(``csrc/conv3x3_smallcin_tf32.cuh``, split TF32, the float block tile's K
walk) stages all Cin channels of a tile at once, 8 for Cin <= 8 and 16 for
Cin 9-10 (:func:`staged_channels`), its weights split once a block; in
bfloat16 the tensor-core tiles take Cin <= 16 as one zero-filled 16-channel
chunk. (The reference runs Cin 9-10 through its wide pack, whose forward and
backward likewise share one packed row.) The kernels work in (B, C, F, T):
the public function takes and returns the JAX package's channel-last layout
as permuted views of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)
from seld_tpu_torch.ops.kernels.conv2d_pool import (
    BLOCK_T, MAX_POOL_F, conv2d_smallcin_bn_relu_fpool, conv2d_windows_bn_relu_fpool,
    staged_channels, tc_block_rows,
)

TILES_PER_BLOCK = 4     # frame tiles one block walks (sizes the partial-sum rows)
F32_TILES_PER_BLOCK = 2   # the float smallcin tile's (F1 and the g_z pass, as K2's kScfTiles)
MAX_POOL_ROWS = 255     # the g_z passes keep each window's routed row in a byte
MAX_CIN = 10            # the reference's wide-pack range, 3 * Cin <= 32
DW_SPLITS = 64          # the dW tile shares its depth (B * F rows x T frames) among ~this many
DW_SPLITS_STAGE1 = 512  # K5's: one Cin tile per block, so more depth shares fill the card
DW_FRAME_STEP = 64      # frames per depth step of the dW tiles (kDwT, kDwfT): a frame share's unit
DW_MAX_CIN = 16         # K5's dW tile: one 16-channel Cin tile (kDwCiStage1)


def kdim(cin: int) -> int:
    """B2's dW row per output channel: (tap, ci) with ci padded to
    :func:`staged_channels`."""
    return 9 * staged_channels(cin)


def max_pool_f(cin: int) -> int:
    """The largest pool_f K5 takes at this Cin, in both dtypes: every pass
    walks a window's rows in stagings (float32's on the float smallcin
    tile in chunks of ``conv2d_pool.float_tile_max_pool_f(cin)`` rows,
    bfloat16's block tile 4 rows a pass), so the bound is the g_z passes'
    routed row, one byte an element (the C entries refuse pf > 255)."""
    return MAX_POOL_ROWS


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def tensor_core_path(x: torch.Tensor) -> bool:
    """True where K5's forward runs its bfloat16 passes (F1 on the
    tensor-core block tile, F2 on K3's tile through K10b's entry: bf16
    products on ``mma.sync``; on CPU tensors their plain versions), False
    where it runs the float32 ones (F1 and F2, K2's kernel, on the float
    smallcin tile: split-TF32 products on the tensor cores, the library's
    TF32 flags off; float64 on the CPU takes their plain versions). B2
    takes :func:`conv_train_gz` and :func:`conv_train_dw_gz` in every
    dtype; each picks its kernel by dtype."""
    return x.dtype == torch.bfloat16


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


def _grid_rows(x, pool_f, block_rows: int | None = None,
               tiles_per_block: int = TILES_PER_BLOCK) -> int:
    """Partial rows of a pass whose blocks take ``block_rows`` conv rows
    (default one pool window) and ``tiles_per_block`` 128-frame tiles."""
    b, _, f, t = x.shape
    n_tiles = -(-t // BLOCK_T)
    rows = block_rows or pool_f
    return b * -(-f // rows) * -(-n_tiles // tiles_per_block)


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
    ``pool_f`` only sets the kernel's tiling (float32: the float smallcin
    tile, one block per pooled row and F32_TILES_PER_BLOCK frame tiles;
    bfloat16: the block tile, ``tc_block_rows(pool_f)`` rows a block)."""
    _check(x, w, pool_f)
    if not on_cuda(x, w):
        return conv_train_stats_plain(x, w)
    code, lib = _launch_prelude(x, w, "conv_train_stats")
    b, cin, f, t = x.shape
    cout = w.shape[3]
    # bf16 runs the block tile: tc_block_rows(pool_f) rows and one frame tile
    # a block (its one pipeline per block; one block an SM)
    bf16 = x.dtype == torch.bfloat16
    rows, tpb = (tc_block_rows(pool_f), 1) if bf16 else (pool_f, F32_TILES_PER_BLOCK)
    partials = torch.empty((_grid_rows(x, pool_f, rows, tpb), 2 * cout), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=x.device)
    err = lib.seld_conv3x3_train_stats(
        x.data_ptr(), w.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        b, cin, f, t, cout, pool_f, tpb, code, stream_handle(x.device))
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

def _route_gz_plain(x, w, g, scale, bias, a, b, pool_f: int):
    """(g_z (B, Cout, F, T) rounded to x's dtype and held in the float type,
    S_g, sum g_pre * acc): g_pre is the pooled cotangent g routed to the
    first row holding each window's max where that max is > 0; g_z = g_pre *
    scale - acc * a - b, the dW product's operand."""
    return route_rows_plain(_conv_plain(x, w), g, scale, bias, a, b, pool_f, x.dtype)


def route_rows_plain(acc, g, scale, bias, a, b, pool_f: int, dtype):
    """:func:`_route_gz_plain` on given conv rows acc (B, Cout, F, T) in the
    float type (the plain conv's, or ``tf32.conv_rows_tf32_plain``'s: the
    float32 kernels' rows), g_z rounded to ``dtype``."""
    cdt = acc.dtype
    bsz, cout, f, t = acc.shape
    col = lambda v: v.to(cdt)[:, None, None]
    y = torch.relu(acc * col(scale) + col(bias)).view(bsz, cout, f // pool_f, pool_f, t)
    m, idx = y.max(dim=3)                                         # first max
    gsel = torch.where(m > 0, g.to(cdt), torch.zeros((), dtype=cdt, device=g.device))
    g_pre = torch.zeros_like(y).scatter_(3, idx.unsqueeze(3), gsel.unsqueeze(3))
    g_pre = g_pre.view(bsz, cout, f, t)
    g_z = (g_pre * col(scale) - acc * col(a) - col(b)).to(dtype).to(cdt)
    return g_z, g_pre.sum((0, 2, 3)), (g_pre * acc).sum((0, 2, 3))


def dw_plain(x, gz) -> torch.Tensor:
    """(3, 3, Cin, Cout) = sum over (b, f, t) of gz * the shifted x, in
    float: the weight gradient of a zero-padded 3x3 conv (the dW tiles'
    function, for K5 and K9; ``ops/kernels/tf32.py::conv_dw_tf32_plain``
    repeats the float32 tile's split-TF32 arithmetic)."""
    cdt = _acc_dtype(x)
    dw = torch.nn.grad.conv2d_weight(x.to(cdt), (gz.shape[1], x.shape[1], 3, 3),
                                     gz.to(cdt), padding=1)
    return dw.permute(2, 3, 1, 0)


def conv_train_dw_plain(x, w, g, scale, bias, a, b, pool_f: int) -> torch.Tensor:
    """(Cout * (K + 2),) = [dW (Cout, 9 taps, CC ci) | S_g | sum g_pre * acc]
    with CC = :func:`staged_channels` and K = 9 * CC (74 or 146 per channel):
    B2 as one function (see :func:`_route_gz_plain`), the oracle the tests
    hold :func:`conv_train_gz` and :func:`conv_train_dw_gz` to."""
    g_z, sg, sga = _route_gz_plain(x, w, g, scale, bias, a, b, pool_f)
    cin = x.shape[1]
    dw = dw_plain(x, g_z).permute(3, 0, 1, 2)                      # (Cout, 3, 3, Cin)
    dw = F.pad(dw, (0, staged_channels(cin) - cin))               # (Cout, 3, 3, CC)
    return torch.cat([dw.reshape(-1), sg, sga])


def _check_g(x, w, g, pool_f) -> None:
    _check(x, w, pool_f)
    bsz, _, f, t = x.shape
    want = (bsz, w.shape[3], f // pool_f, t)
    if tuple(g.shape) != want:
        raise ValueError(f"g must be {want}, got {tuple(g.shape)}")


def conv_train_gz_plain(x, w, g, scale, bias, a, b, pool_f: int):
    """(g_z (B, Cout, F, T) in x's dtype, (2 * Cout,) = [S_g | sum g_pre *
    acc]): :func:`_route_gz_plain`'s routing and g_z, the first half of
    B2."""
    g_z, sg, sga = _route_gz_plain(x, w, g, scale, bias, a, b, pool_f)
    return g_z.to(x.dtype), torch.cat([sg, sga])


def conv_train_gz(x, w, g, scale, bias, a, b, pool_f: int):
    """B2, g_z: x (B, Cin, F, T), w (3, 3, Cin, Cout), g (B, Cout, F/pf, T)
    in one dtype, per-channel scale, bias, a, b -> (g_z (B, Cout, F, T) in
    x's dtype, (2 * Cout,) float32 routed sums). CUDA tensors launch
    ``seld_conv3x3_train_gz`` (float32: one recompute on the float smallcin
    tile, F1's and F2's rows; bfloat16: the conv tile's rows); CPU tensors
    take :func:`conv_train_gz_plain`."""
    _check_g(x, w, g, pool_f)
    bsz, cin, f, t = x.shape
    cout = w.shape[3]
    if not on_cuda(x, w, g, scale, bias, a, b):
        return conv_train_gz_plain(x, w, g, scale, bias, a, b, pool_f)
    code, lib = _launch_prelude(x, w, "conv_train_gz")
    require_contiguous(g=g)
    if g.dtype != x.dtype:
        raise TypeError(f"g is {g.dtype}, x is {x.dtype}")
    gz = torch.empty((bsz, cout, f, t), dtype=x.dtype, device=x.device)
    tpb = TILES_PER_BLOCK if x.dtype == torch.bfloat16 else F32_TILES_PER_BLOCK
    partials = torch.empty((_grid_rows(x, pool_f, tiles_per_block=tpb), 2 * cout),
                           dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * cout, dtype=torch.float32, device=x.device)
    cols = [_col(v) for v in (scale, bias, a, b)]
    err = lib.seld_conv3x3_train_gz(
        x.data_ptr(), w.data_ptr(), *[c.data_ptr() for c in cols], g.data_ptr(), gz.data_ptr(),
        partials.data_ptr(), sums.data_ptr(), bsz, cin, f, t, cout, pool_f, tpb, code,
        stream_handle(x.device))
    _build.check(err, "seld_conv3x3_train_gz")
    launch_counts["conv_train_gz"] += 1
    return gz, sums


def dw_split(b: int, f: int, t: int, target: int = DW_SPLITS) -> tuple[int, int, int]:
    """(rows_per_split, frames_per_split, splits) of the dW tiles (bf16, and
    the float32 split-TF32 tile): the B * F rows shared among at most
    ``target`` blocks, and where there are fewer rows than that (K9's stage
    3: 8 at batch 2), each row's frames split in
    multiples of DW_FRAME_STEP until about ``target`` shares. ``splits`` is
    the kernels' grid.x and the partials' row count; block x takes rows
    share x // frame_splits and frames share x % frame_splits, frame_splits
    = ceil(T / frames_per_split)."""
    rows = b * f
    if rows >= target:
        rows_per_split, frames_per_split = -(-rows // target), t
    else:
        parts = min(-(-target // rows), -(-t // DW_FRAME_STEP))
        steps = -(-t // (parts * DW_FRAME_STEP))   # ceil(ceil(t / parts) / step)
        rows_per_split, frames_per_split = 1, steps * DW_FRAME_STEP
    return (rows_per_split, frames_per_split,
            -(-rows // rows_per_split) * -(-t // frames_per_split))


def conv_train_dw_gz(x: torch.Tensor, gz: torch.Tensor) -> torch.Tensor:
    """B2, dW: x (B, Cin, F, T) with Cin <= 16 and gz (B, Cout, F, T) from
    :func:`conv_train_gz`, one dtype -> dW (3, 3, Cin, Cout) float32. CUDA
    tensors launch ``seld_conv3x3_train_dw_tc`` (bfloat16: the dW tile with
    a 16-channel Cin tile; float32: the split-TF32 tile, 8 channels with the
    three dx taps stacked in M at Cin <= 8, else 16; depth shared by
    :func:`dw_split` among about DW_SPLITS_STAGE1 blocks); CPU tensors take
    :func:`dw_plain`."""
    if x.ndim != 4 or gz.ndim != 4 or x.shape[0] != gz.shape[0] or x.shape[2:] != gz.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and gz {tuple(gz.shape)} must be (B, *, F, T) "
                         "of one B, F and T")
    if not 1 <= x.shape[1] <= DW_MAX_CIN:
        raise ValueError(f"K5's dW tile takes Cin <= {DW_MAX_CIN}, got {x.shape[1]}")
    if not on_cuda(x, gz):
        return dw_plain(x, gz)
    require_contiguous(x=x, gz=gz)
    if x.dtype != gz.dtype:
        raise TypeError(f"conv_train_dw_gz takes x and gz of one dtype, got {x.dtype} and "
                        f"{gz.dtype}")
    code, lib = dtype_code(x), _build.load()
    b, cin, f, t = x.shape
    cout = gz.shape[1]
    rows_per_split, frames_per_split, splits = dw_split(b, f, t, DW_SPLITS_STAGE1)
    partials = torch.empty((splits, 9 * cin * cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    err = lib.seld_conv3x3_train_dw_tc(
        x.data_ptr(), gz.data_ptr(), partials.data_ptr(), dw.data_ptr(), b, cin, f, t, cout,
        rows_per_split, frames_per_split, code, stream_handle(x.device))
    _build.check(err, "seld_conv3x3_train_dw_tc")
    launch_counts["conv_train_dw"] += 1
    return dw


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
    """(x (B, Cin, F, T), w, gamma, beta) -> (out (B, Cout, F/pf, T), mean, var).
    With a ``cross_rank`` hook (data parallelism) F1's and B1's sums are summed
    over the ranks between the passes, and n counts every rank's rows."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, pool_f, eps, cross_rank):
        cout = w.shape[3]
        n = x.shape[0] * x.shape[2] * x.shape[3]
        sums = conv_train_stats(x, w, pool_f)
        # the batch statistics and the BN affine in float64 from F1's sums,
        # each column rounded once where a kernel takes it: stage 1's affine
        # is where a float32 step is most sensitive (an ulp of its bias moves
        # every gradient by ~1e-3 at the flagship's size); across ranks the
        # float64 copies are summed, so the statistics are formed once from them
        s64 = sums.double()
        if cross_rank is not None:
            s64 = cross_rank.sum(s64, "K5 F1")
            n *= cross_rank.world
        mean = s64[:cout] / n
        var = torch.clamp(s64[cout:] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma.double() * inv
        bias = beta.double() - mean * scale
        if on_cuda(x, w):   # F2, fed the batch-statistics affine
            f2 = (conv2d_windows_bn_relu_fpool if tensor_core_path(x)
                  else conv2d_smallcin_bn_relu_fpool)
            out = f2(x, w, _col(scale), _col(bias), pool_f)
        else:
            out = conv_train_fwd_plain(x, w, scale, bias, pool_f)
        ctx.save_for_backward(x, w, out, mean, inv, scale, bias)
        ctx.pool_f, ctx.n, ctx.cross_rank = pool_f, n, cross_rank
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        mean_out, var_out = mean.to(sums.dtype), var.to(sums.dtype)
        ctx.mark_non_differentiable(mean_out, var_out)
        return out, mean_out, var_out

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        x, w, out, mean, inv, scale, bias = ctx.saved_tensors
        cout, n = w.shape[3], ctx.n
        g = g_out.to(out.dtype).contiguous()
        # B1: the correction terms' sums, from the pooled output; a channel
        # with scale == 0 has no recoverable xhat and gets p = q = 0 (its
        # g_z correction is multiplied by scale == 0 anyway)
        zero = scale == 0
        safe = torch.where(zero, torch.ones_like(scale), scale)
        p = torch.where(zero, torch.zeros_like(scale), inv / safe)
        q = torch.where(zero, torch.zeros_like(scale), (bias / safe + mean) * inv)
        sel = sel_stats(out, g, p, q)
        if ctx.cross_rank is not None:   # the correction terms of the global batch
            sel = ctx.cross_rank.sum(sel, "K5 B1")
        c1, c2 = sel[:cout] / n, sel[cout:] / n
        a = inv * scale * c2
        b = scale * c1 - mean * a
        # B2: dW and the exact routed sums (dgamma, dbeta come from these)
        gz, sums = conv_train_gz(x, w, g, scale, bias, a, b, ctx.pool_f)
        dw = conv_train_dw_gz(x, gz)
        del gz
        sg, sga = sums[:cout], sums[cout:]
        dgamma = inv * (sga - mean * sg)
        g_dt, b_dt = ctx.param_dtypes
        return None, dw.to(w.dtype).contiguous(), dgamma.to(g_dt), sg.to(b_dt), None, None, None


def conv2d_bn_relu_fpool_train(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, pool_f: int, eps: float = 1e-5,
                               out_layout: str = "channel_last", cross_rank=None):
    """x (B, F, T, Cin) with 3 * Cin <= 32, w (3, 3, Cin, Cout) in x's dtype,
    gamma / beta (Cout,) -> (out (B, F/pf, T, Cout) in x's dtype, mean
    (Cout,), var (Cout,)); pool_f <= :func:`max_pool_f` (Cin).

    Differentiable in w, gamma and beta (not x); mean and var are the biased
    batch statistics for the caller's running-average update. out is a
    channel-last view of the kernels' (B, Cout, F/pf, T) result, or that
    result itself with ``out_layout='CT'`` (the layout stages 2-3 take).
    ``cross_rank`` (``parallel/cross_rank.py``): x is this rank's rows of a
    global batch, and the statistics (mean and var too) are the global
    batch's; dW, dgamma and dbeta stay this rank's share of the gradient of
    the ranks' summed losses."""
    if out_layout not in ("channel_last", "CT"):
        raise ValueError(f"out_layout {out_layout!r} not in ('channel_last', 'CT')")
    xc = x.permute(0, 3, 1, 2).contiguous()
    out, mean, var = _ConvTrainFn.apply(xc, w.contiguous(), gamma, beta, pool_f, eps,
                                        cross_rank)
    return (out if out_layout == "CT" else out.permute(0, 2, 3, 1)), mean, var
