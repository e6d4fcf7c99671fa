"""Per-piece profile of the flagship serving pipeline's stages on the card.

    python -m seld_tpu_torch.profile_stages [--device=cpu]

Counterpart of ``tools/profile_stages.py``. Environment, as there:
``PROF_BATCH`` (default 16) and ``PROF_SECTIONS`` (comma-separated, default
``stft,cnn,tcn``; also ``fused``, ``qmm``, ``train``, ``attn``, ``f32``, ``v3`` and ``walls``). The ``noop`` row, the
dispatch baseline, always runs. Sections:

- ``stft``: K1 (float32 and bfloat16 out) beside its plain version;
- ``cnn``: the three DQ conv stages (conv, ReLU, pool) and two convs alone,
  through ``ops/dual_quaternion.py``;
- ``tcn``: one ResBlock's DQ convs (dilation 55), the pointwise conv and the
  dilated conv alone;
- ``fused``: K2 (the smallcin kernel) at stage 1, K10a (im2col) and K10b
  (per-tap windows) at stages 1-3, float32 scale and bias, and K10a's
  operands (the patch kernel and the padded weights) alone at each stage;
- ``qmm``: K7 (Q and DQ, float32 and bfloat16) beside the plain ops, and K8;
- ``train``: K5's bfloat16 passes at stage 1 (F1, F2, B2's g_z pass and dW
  tile) beside cuDNN's weight gradient on the same g_z, then K9's B1 and
  g_z at stages 2 and 3 (bf16 g; pre warm in the L2 where it fits);
- ``attn``: K4 and K6 (bfloat16) at the flagship's attention (T = frames
  / 2 after the TCN's time pool, 8 heads of 48, then of 160, 256 and 640:
  ``ATTN_WIDE_DIMS``, the kernels past head dim 128) beside
  ``scaled_dot_product_attention`` and its backward on the same inputs;
- ``f32``: the float32 kernels in split TF32 beside their library call in
  float32 (TF32 off), on the same inputs: K4 and K6 at the flagship's
  attention (T = frames / 2, 8 heads of 48, then of 160, ``F32_WIDE_DIM``:
  the wide kernels past head dim 128) beside SDPA's forward and
  backward, K7 (the DQ conv table) at the flagship's pointwise convs (M =
  batch x frames, 384 x 384) beside ``addmm`` on the assembled weight,
  K9's dW at stage 2 and, at stage 1, K5's F1 and K2 (K5's F2; both on
  the float smallcin tile) and K5's B2 (its g_z pass on the same tile,
  then the split-TF32 dW tile) beside cuDNN's weight gradient, K2w at
  stage 1 and K10a at stages 1-3 (the conv-pool GEMM tile, each wrapper
  with its operand build), at stage 2 K3, K10b and K9's F1 (the conv
  block tile), beside cuDNN's float32 conv of the stage, K9's dh at
  stages 2 and 3 (the block tile on the transposed weights), and K9's B1
  and g_z at stages 2 and 3 (float32 g);
- ``v3``: K2w at stage 1 and its pack (torch) alone, then the flagship's
  ``model(x)`` beside
  ``fused_infer`` in bfloat16 under ``smallcin_impl`` 'thin' and 'wide';
- ``walls``: the host-bound paths, whose events time the host's dispatch
  with the device's work: ``WALL_CALLS`` back-to-back K7 wrapper calls at
  M 64 (the host's cost of one call, in µs, is the row's ms), a fused bf16
  ``serve`` request of ``batch`` clips with the audio on the card, the
  flagship's apply forward of one clip in float32 on K7 and in bf16 on K8,
  and one bf16 training step at ``batch``. It calls only entry points that
  the package's earlier versions have too, so that ``ab_variants
  --base-tree`` times an earlier tree's walls against this one's.

Each row prints the median of 5 timed runs after one warm-up: CUDA events on
the card, whose name and power limit the first line gives; the host clock
with ``--device=cpu``, which says so. A row that runs out of device memory
prints ``FAILED`` and the profile goes on; the tool then exits non-zero.
The last line is a JSON object of the kernels' launch counts.

Each section is a generator of rows, a function of (batch, device,
shapes) with the flagship's shapes as defaults (:data:`FLAGSHIP`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = {
    "channels": 8,             # microphone channels
    "samples": 32000 * 60,     # one minute at 32 kHz
    "freq": 256,               # STFT bins
    "frames": 4800,            # STFT frames
    "filters": 192,            # CNN channels
    "pools": (8, 8, 2),        # frequency pools of the three stages
    "tcn_width": 384,          # G = U
    "dilation": 55,            # the widest fibonacci dilation of the ResBlocks
    "heads": 8,                # attention heads
    "head_dim": 48,            # V[0] / heads
    "config": ROOT / "config" / "DQSELD-TCN-S1-PHI_8ch.txt",
}
DEFAULT_SECTIONS = "stft,cnn,tcn"
ATTN_WIDE_DIMS = (160, 256, 640)   # the attn section's head dims past 128
F32_WIDE_DIM = 160   # the f32 section's head dim past 128
WALL_CALLS = 1000   # the walls section's back-to-back K7 wrapper calls
ITERS = 5


def _randn(device, *shape, dtype=torch.float32, gen=None):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def noop(batch, device, shapes=FLAGSHIP):
    yield "noop (dispatch baseline)", lambda t: t + 1.0, (torch.zeros(8, 128, device=device),)


def stft(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.kernels.stft import stft_mag, stft_mag_plain

    gen = torch.Generator(device=device).manual_seed(0)
    audio = _randn(device, batch, shapes["channels"], shapes["samples"], gen=gen)
    yield "stft: K1 stft_mag (f32 out)", lambda a: stft_mag(a, out_dtype=torch.float32), (audio,)
    yield "stft: K1 stft_mag (bf16 out)", lambda a: stft_mag(a, out_dtype=torch.bfloat16), (audio,)
    yield "stft: plain stft_mag_plain (f32 out)", stft_mag_plain, (audio,)


def _dq_stage(pool_f):
    from seld_tpu_torch.models.layers import max_pool_2d
    from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_conv

    return lambda x, w: max_pool_2d(torch.relu(dual_quaternion_conv(x, w, None, padding=1)),
                                    (pool_f, 1))


def cnn(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_conv

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f, t, c, pools = torch.bfloat16, shapes["freq"], shapes["frames"], shapes["filters"], \
        shapes["pools"]
    conv = lambda x, w: dual_quaternion_conv(x, w, None, padding=1)
    cin = shapes["channels"]
    x1 = _randn(device, batch, f, t, cin, dtype=bf16, gen=gen)
    w1 = _randn(device, 8, 3, 3, cin // 8, c // 8, dtype=bf16, gen=gen)
    yield f"cnn1: DQconv {cin}->{c} ({f},{t})+pool", _dq_stage(pools[0]), (x1, w1)
    yield "cnn1 conv only (b4)", conv, (x1[:4], w1)
    del x1
    f2 = f // pools[0]
    x2 = _randn(device, batch, f2, t, c, dtype=bf16, gen=gen)
    w2 = _randn(device, 8, 3, 3, c // 8, c // 8, dtype=bf16, gen=gen)
    yield f"cnn2: DQconv {c}->{c} ({f2},{t})+pool", _dq_stage(pools[1]), (x2, w2)
    yield "cnn2 conv only (b4)", conv, (x2[:4], w2)
    del x2
    f3 = f2 // pools[1]
    x3 = _randn(device, batch, f3, t, c, dtype=bf16, gen=gen)
    yield f"cnn3: DQconv {c}->{c} ({f3},{t})+pool", _dq_stage(pools[2]), (x3, w2)


def tcn(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_conv

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, width, dil = torch.bfloat16, shapes["tcn_width"], shapes["dilation"]
    xt = _randn(device, batch, shapes["frames"], width, dtype=bf16, gen=gen)
    wt = _randn(device, 8, 3, width // 8, width // 8, dtype=bf16, gen=gen)
    wp = _randn(device, 8, 1, width // 8, width // 8, dtype=bf16, gen=gen)
    dilated = lambda x, w: dual_quaternion_conv(x, w, None, padding=dil, dilation=dil)

    def resblock_convs(x, wf, wg, ws, wr):
        y = torch.tanh(dilated(x, wf)) * torch.sigmoid(dilated(x, wg))
        return x + dual_quaternion_conv(y, wr, None), dual_quaternion_conv(y, ws, None)

    yield f"tcn: 1 resblock convs (dil {dil})", resblock_convs, (xt, wt, wt, wp, wp)
    yield f"tcn: pointwise 1x1 {width}->{width}", lambda x, w: dual_quaternion_conv(x, w, None), \
        (xt, wp)
    yield f"tcn: dilated conv only (dil {dil})", dilated, (xt, wt)


def fused(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_im2col_bn_relu_fpool, conv2d_smallcin_bn_relu_fpool, conv2d_windows_bn_relu_fpool,
        im2col_operands,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f, t, c, pools = torch.bfloat16, shapes["freq"], shapes["frames"], shapes["filters"], \
        shapes["pools"]
    cin = shapes["channels"]
    s1, b1 = _randn(device, c, gen=gen), _randn(device, c, gen=gen)

    def stage(kernel_fn, pool_f):
        return lambda x, w: kernel_fn(x, w, s1, b1, pool_f)

    x1 = _randn(device, batch, cin, f, t, dtype=bf16, gen=gen)
    w1 = assemble_dq_conv_kernel(_randn(device, 8, 3, 3, cin // 8, c // 8, gen=gen)).to(bf16)
    x1s = x1[:4]
    yield f"fused1: K2 smallcin (K={9 * cin})", stage(conv2d_smallcin_bn_relu_fpool, pools[0]), \
        (x1, w1)
    yield f"fused1: K10a im2col (K={9 * cin})", stage(conv2d_im2col_bn_relu_fpool, pools[0]), \
        (x1, w1)
    yield f"fused1: K10a patches alone (K={9 * cin})", im2col_operands, (x1, w1)
    yield f"fused1: K10a im2col (K={9 * cin}) b4", stage(conv2d_im2col_bn_relu_fpool, pools[0]), \
        (x1s, w1)
    yield "fused1: K10b windows b4", stage(conv2d_windows_bn_relu_fpool, pools[0]), (x1s, w1)
    yield f"fused1: K10b windows (K={cin}/tap)", stage(conv2d_windows_bn_relu_fpool, pools[0]), \
        (x1, w1)
    del x1, x1s
    w2 = assemble_dq_conv_kernel(_randn(device, 8, 3, 3, c // 8, c // 8, gen=gen)).to(bf16)
    f2 = f // pools[0]
    for i, (fi, pool_f) in enumerate(((f2, pools[1]), (f2 // pools[1], pools[2])), start=2):
        xi = _randn(device, batch, c, fi, t, dtype=bf16, gen=gen)
        yield f"fused{i}: K10a im2col (K={9 * c})", stage(conv2d_im2col_bn_relu_fpool, pool_f), \
            (xi, w2)
        yield f"fused{i}: K10a patches alone (K={9 * c})", im2col_operands, (xi, w2)
        yield f"fused{i}: K10b windows (K={c}/tap)", stage(conv2d_windows_bn_relu_fpool, pool_f), \
            (xi, w2)
        del xi


def qmm(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.dual_quaternion import dual_quaternion_linear
    from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel
    from seld_tpu_torch.ops.kernels.qmatmul import pallas_dq_linear, pallas_q_linear
    from seld_tpu_torch.ops.kernels.quant import int8_matmul, quantize_weight_per_channel
    from seld_tpu_torch.ops.quaternion import quaternion_linear

    gen = torch.Generator(device=device).manual_seed(0)
    width, rows = shapes["tcn_width"], batch * shapes["frames"]
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        xt = _randn(device, rows, width, dtype=dtype, gen=gen)
        w8 = _randn(device, 8, width // 8, width // 8, dtype=dtype, gen=gen)
        w4 = _randn(device, 4, width // 4, width // 4, dtype=dtype, gen=gen)
        dims = f"{width}x{width}"
        yield f"qmm {tag}: plain DQ {dims}", lambda x, w: dual_quaternion_linear(x, w, None), \
            (xt, w8)
        yield f"qmm {tag}: K7 DQ {dims}", \
            lambda x, w: pallas_dq_linear(x, w, None, conv_table=True), (xt, w8)
        yield f"qmm {tag}: plain Q {dims}", lambda x, w: quaternion_linear(x, w, None), (xt, w4)
        yield f"qmm {tag}: K7 Q {dims}", lambda x, w: pallas_q_linear(x, w, None), (xt, w4)
    xt = _randn(device, rows, width, dtype=torch.bfloat16, gen=gen)
    wq, ws = quantize_weight_per_channel(
        assemble_dq_conv_kernel(_randn(device, 8, 1, width // 8, width // 8, gen=gen))[0])
    yield f"qmm int8: K8 PTQ DQ {width}x{width}", lambda x, q, s: int8_matmul(x, q, s, None), \
        (xt, wq, ws)


def train(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_windows_bn_relu_fpool

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f, t, c, pf = torch.bfloat16, shapes["freq"], shapes["frames"], shapes["filters"], \
        shapes["pools"][0]
    cin = shapes["channels"]
    x = _randn(device, batch, cin, f, t, dtype=bf16, gen=gen)
    w = (_randn(device, 3, 3, cin, c, gen=gen) / 8).to(bf16)
    g = _randn(device, batch, c, f // pf, t, dtype=bf16, gen=gen)
    scale = _randn(device, c, gen=gen).abs() + 0.5
    bias, a, b = (_randn(device, c, gen=gen) / 4 for _ in range(3))
    b2 = (x, w, g, scale, bias, a, b, pf)
    gz = k5.conv_train_gz(*b2)[0]
    yield f"train1: K5 F1 stats (pf {pf})", lambda xx, ww: k5.conv_train_stats(xx, ww, pf), (x, w)
    yield "train1: K5 F2 windows", \
        lambda xx, ww: conv2d_windows_bn_relu_fpool(xx, ww, scale, bias, pf), (x, w)
    yield "train1: K5 B2 g_z pass", k5.conv_train_gz, b2
    yield "train1: K5 B2 dW tile", k5.conv_train_dw_gz, (x, gz)
    yield "train1: cuDNN wgrad on g_z", \
        lambda xx, zz: torch.nn.grad.conv2d_weight(xx, (c, cin, 3, 3), zz, padding=1), (x, gz)
    del x, w, g, gz, b2
    yield from _k9_route(batch, device, shapes, bf16, "train", gen)


def _k9_route(batch, device, shapes, dtype, prefix, gen):
    """K9's B1 and g_z (the streaming walker) at the flagship's stages 2 and
    3 on random pre and g of ``dtype``; pre stays in the L2 where it fits
    (stage 3: 29.5 MB at batch 2), so these rows are warm."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9

    c, t, pools = shapes["filters"], shapes["frames"], shapes["pools"]
    f = shapes["freq"] // pools[0]
    for stage, fi, pf in ((2, f, pools[1]), (3, f // pools[1], pools[2])):
        pre = _randn(device, batch, c, fi, t, gen=gen)
        g = _randn(device, batch, c, fi // pf, t, dtype=dtype, gen=gen)
        cols = torch.stack([_randn(device, c, gen=gen).abs() + 0.5,
                            *(_randn(device, c, gen=gen) / 4 for _ in range(5))])
        yield f"{prefix}: K9 B1 stage {stage} ({c} x {fi} x {t}, pf {pf})", \
            lambda pp, gg, cc, pf_=pf: k9.ct_sel_stats(pp, gg, cc, pf_), (pre, g, cols)
        yield f"{prefix}: K9 g_z stage {stage}", \
            lambda pp, gg, cc, pf_=pf: k9.ct_gz(pp, gg, cc, pf_), (pre, g, cols)
        del pre, g, cols


def attn(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_bwd

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, t, h = torch.bfloat16, shapes["frames"] // 2, shapes["heads"]
    for d in (shapes["head_dim"], *ATTN_WIDE_DIMS):
        tag = "" if d == shapes["head_dim"] else f" (D {d})"
        q, k, v, dout = (_randn(device, batch, t, h, d, dtype=bf16, gen=gen) for _ in range(4))
        scale = d ** -0.5
        out, lse = flash_attention(q, k, v, scale)
        yield (f"attn: K4 forward (T {t}, {h} x {d})",
               lambda a, b_, c, s_=scale: flash_attention(a, b_, c, s_), (q, k, v))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        yield (f"attn: SDPA forward{tag}",
               lambda a, b_, c, s_=scale: F.scaled_dot_product_attention(a, b_, c, scale=s_),
               (qt, kt, vt))
        yield (f"attn: K6 backward{tag}",
               lambda *a, s_=scale: flash_attention_bwd(*a, s_), (q, k, v, out, dout, lse))
        leaves = [a.detach().requires_grad_() for a in (qt, kt, vt)]
        o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
        yield (f"attn: SDPA backward{tag}",
               lambda g, o_=o_lib, l_=leaves: torch.autograd.grad(o_, l_, g, retain_graph=True),
               (dout.transpose(1, 2).contiguous(),))
        del q, k, v, dout, out, lse, qt, kt, vt, leaves, o_lib


def f32(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.ops.hamilton import assemble_hamilton
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_bwd
    from seld_tpu_torch.ops.kernels.qmatmul import hamilton_matmul

    gen = torch.Generator(device=device).manual_seed(0)
    t, h = shapes["frames"] // 2, shapes["heads"]
    for d in (shapes["head_dim"], F32_WIDE_DIM):
        tag = "" if d == shapes["head_dim"] else f" (D {d})"
        q, k, v, dout = (_randn(device, batch, t, h, d, gen=gen) for _ in range(4))
        scale = d ** -0.5
        out, lse = flash_attention(q, k, v, scale)
        yield (f"f32: K4 forward (T {t}, {h} x {d})",
               lambda a, b_, c, s_=scale: flash_attention(a, b_, c, s_), (q, k, v))
        leaves = [a.transpose(1, 2).contiguous().requires_grad_() for a in (q, k, v)]
        yield (f"f32: SDPA forward{tag}",
               lambda a, b_, c, s_=scale: F.scaled_dot_product_attention(a, b_, c, scale=s_),
               [a.detach() for a in leaves])
        yield (f"f32: K6 backward (T {t}, {h} x {d})",
               lambda *a, s_=scale: flash_attention_bwd(*a, s_), (q, k, v, out, dout, lse))
        o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
        yield (f"f32: SDPA backward{tag}",
               lambda g, o_=o_lib, l_=leaves: torch.autograd.grad(o_, l_, g, retain_graph=True),
               (dout.transpose(1, 2).contiguous(),))
        del q, k, v, dout, out, lse, leaves, o_lib
    width, rows = shapes["tcn_width"], batch * shapes["frames"]
    x = _randn(device, rows, width, gen=gen)
    comps = _randn(device, 8, width // 8, width // 8, gen=gen) / (width // 8) ** 0.5
    bias = _randn(device, width, gen=gen)
    w_full = assemble_hamilton(comps, False)
    yield (f"f32: K7 DQ (M {rows}, {width}x{width})",
           lambda xx, cc: hamilton_matmul(xx, cc, bias, 8, False), (x, comps))
    yield "f32: addmm", lambda xx, ww: torch.addmm(bias, xx, ww), (x, w_full)
    del x, comps, bias, w_full
    c, f, t = shapes["filters"], shapes["freq"] // shapes["pools"][0], shapes["frames"]
    x = _randn(device, batch, c, f, t, gen=gen)
    gz = _randn(device, batch, c, f, t, gen=gen) / 100
    yield f"f32: K9 dW stage 2 ({c} x {f} x {t})", k9.ct_dw, (x, gz)
    yield "f32: cuDNN wgrad stage 2", \
        lambda xx, zz: torch.nn.grad.conv2d_weight(xx, (c, c, 3, 3), zz, padding=1), (x, gz)
    del x, gz
    cin, f, pf = shapes["channels"], shapes["freq"], shapes["pools"][0]
    x = _randn(device, batch, cin, f, t, gen=gen)
    w = _randn(device, 3, 3, cin, c, gen=gen) / 8
    g = _randn(device, batch, c, f // pf, t, gen=gen)
    scale = _randn(device, c, gen=gen).abs() + 0.5
    bias, a, b = (_randn(device, c, gen=gen) / 4 for _ in range(3))
    b2 = (x, w, g, scale, bias, a, b, pf)
    gz = k5.conv_train_gz(*b2)[0]
    yield f"f32: K5 F1 stats stage 1 (pf {pf})", lambda xx, ww: k5.conv_train_stats(xx, ww, pf), \
        (x, w)
    yield "f32: K2 stage 1 (K5's F2)", \
        lambda xx, ww: pool.conv2d_smallcin_bn_relu_fpool(xx, ww, scale, bias, pf), (x, w)
    yield f"f32: K5 g_z pass stage 1 ({cin} -> {c} x {f} x {t}, pf {pf})", k5.conv_train_gz, b2
    yield "f32: K5 dW tile stage 1", k5.conv_train_dw_gz, (x, gz)
    yield "f32: cuDNN wgrad stage 1", \
        lambda xx, zz: torch.nn.grad.conv2d_weight(xx, (c, cin, 3, 3), zz, padding=1), (x, gz)
    del x, w, g, gz, b2
    pools = shapes["pools"]
    stages = ((cin, f, pools[0]), (c, f // pools[0], pools[1]),
              (c, f // pools[0] // pools[1], pools[2]))
    for i, (ci, fi, pf_i) in enumerate(stages, start=1):
        x = _randn(device, batch, ci, fi, t, gen=gen)
        w = _randn(device, 3, 3, ci, c, gen=gen) / (9 * ci) ** 0.5
        if i == 1:
            yield (f"f32: K2w stage 1 (K {3 * pool.smallcin_rows(ci)})",
                   lambda xx, ww, pf_=pf_i: pool.conv2d_smallcin_wide_bn_relu_fpool(
                       xx, ww, scale, bias, pf_), (x, w))
        yield (f"f32: K10a stage {i} (K {9 * ci})",
               lambda xx, ww, pf_=pf_i: pool.conv2d_im2col_bn_relu_fpool(xx, ww, scale, bias, pf_),
               (x, w))
        if i == 2:   # the float block tile: K3 and K10b (K3's kernel) and K9's F1
            yield (f"f32: K3 stage 2 ({ci} -> {c} x {fi} x {t}, pf {pf_i})",
                   lambda xx, ww, pf_=pf_i: pool.conv2d_widecin_bn_relu_fpool(
                       xx, ww, scale, bias, pf_), (x, w))
            yield ("f32: K10b stage 2",
                   lambda xx, ww, pf_=pf_i: pool.conv2d_windows_bn_relu_fpool(
                       xx, ww, scale, bias, pf_), (x, w))
            yield "f32: K9 F1 stage 2", lambda xx, ww, pf_=pf_i: k9.ct_train_stats(xx, ww, pf_), \
                (x, w)
        if i > 1:   # K9's dh on the same tile, x standing in for g_z (Cin = Cout here)
            yield f"f32: K9 dh stage {i}", lambda zz, ww: k9.ct_dx(zz, ww), (x, w)
        yield (f"f32: cuDNN conv stage {i}", lambda xx, ww: F.conv2d(xx, ww, padding=1),
               (x, w.permute(3, 2, 0, 1).contiguous()))
        del x, w
    yield from _k9_route(batch, device, shapes, torch.float32, "f32", gen)


def v3(batch, device, shapes=FLAGSHIP):
    from seld_tpu_torch.models.fused_infer import fused_infer
    from seld_tpu_torch.ops.hamilton import assemble_dq_conv_kernel
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_smallcin_wide_bn_relu_fpool, smallcin_pack,
    )
    from seld_tpu_torch.serve import build_flagship

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f, t, cin = torch.bfloat16, shapes["freq"], shapes["frames"], shapes["channels"]
    c = shapes["filters"]
    x1 = _randn(device, batch, cin, f, t, dtype=bf16, gen=gen)
    w1 = assemble_dq_conv_kernel(_randn(device, 8, 3, 3, cin // 8, c // 8, gen=gen)).to(bf16)
    s1, b1 = _randn(device, c, gen=gen), _randn(device, c, gen=gen)
    yield "v3 stage1: K2w wide pack (K=96)", \
        lambda x, w: conv2d_smallcin_wide_bn_relu_fpool(x, w, s1, b1, shapes["pools"][0]), (x1, w1)
    yield "v3 stage1: K2w pack alone (torch)", smallcin_pack, (x1, w1)
    del x1, w1
    model = build_flagship(shapes["config"], bf16, device, torch.Generator().manual_seed(0))
    x = _randn(device, batch, cin, f, t, gen=gen)

    def apply(xx):
        with torch.no_grad():
            return model(xx.to(bf16))

    yield "v3 model(x) (bf16)", apply, (x,)
    yield "v3 fused_infer (bf16, thin)", lambda xx: fused_infer(model, xx), (x,)
    yield "v3 fused_infer (bf16, wide)", lambda xx: fused_infer(model, xx, smallcin_impl="wide"), \
        (x,)


def walls(batch, device, shapes=FLAGSHIP):
    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import make_task2_batch
    from seld_tpu_torch.ops.kernels.qmatmul import pallas_q_linear
    from seld_tpu_torch.serve import build_flagship, serve
    from seld_tpu_torch.training import create_train_state, make_train_step

    gen = torch.Generator(device=device).manual_seed(0)
    xs, w4 = _randn(device, 64, 32, gen=gen), _randn(device, 4, 8, 8, gen=gen)

    def k7_calls(x, w):
        for _ in range(WALL_CALLS):
            pallas_q_linear(x, w, None)

    yield f"walls: K7 wrapper x{WALL_CALLS} (M 64)", k7_calls, (xs, w4)
    cfg_path, cin = shapes["config"], shapes["channels"]
    model = build_flagship(cfg_path, torch.bfloat16, device, torch.Generator().manual_seed(0))
    audio = _randn(device, batch, cin, shapes["samples"], gen=gen)

    def request(a):
        with torch.no_grad():
            return serve(model, a)

    yield f"walls: serve fused bf16, batch {batch}", request, (audio,)
    del audio
    x1 = _randn(device, 1, cin, shapes["freq"], shapes["frames"], gen=gen)
    for dtype, qconv, tag in ((torch.float32, "pallas", "f32 K7"), (torch.bfloat16, "int8",
                                                                     "bf16 K8")):
        applied = build_flagship(cfg_path, dtype, device, torch.Generator().manual_seed(0),
                                 qconv_impl=qconv)

        def apply(xx, m=applied, dt=dtype):
            with torch.no_grad():
                return m(xx.to(dt))

        yield f"walls: apply {tag}, one clip", apply, (x1,)
        del applied
    cfg = load_config(str(cfg_path)).replace(compute_dtype="bfloat16")
    state = [create_train_state(model, cfg, torch.Generator(device=device).manual_seed(2))]
    step = make_train_step(cfg)
    x, y = make_task2_batch(np.random.default_rng(0), batch, channels=cin, freq=shapes["freq"],
                            time_frames=shapes["frames"], label_frames=shapes["frames"] // 8)

    def train_step(xx, yy):
        state[0], loss = step(state[0], xx, yy)
        return loss

    yield f"walls: train step bf16, batch {batch}", train_step, \
        (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


SECTIONS = {"noop": noop, "stft": stft, "cnn": cnn, "tcn": tcn, "fused": fused, "qmm": qmm,
            "train": train, "attn": attn, "f32": f32, "v3": v3, "walls": walls}


def time_ms(fn, args, device: torch.device, iters: int = ITERS) -> float:
    """Median milliseconds of fn(*args) over ``iters`` runs after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(sections, batch: int, device: torch.device, shapes=FLAGSHIP,
        iters: int = ITERS) -> dict:
    """Time every row of ``sections`` (``noop`` first); prints one line per
    row and returns {row: ms, or None where the card ran out of memory}."""
    results = {}
    for name in ["noop", *(s for s in sections if s != "noop")]:
        for row, fn, args in SECTIONS[name](batch, device, shapes):
            try:
                ms = time_ms(fn, args, device, iters)
            except torch.cuda.OutOfMemoryError as e:
                results[row] = None
                print(f"{row:44s}   FAILED: {str(e).splitlines()[0][:100]}", flush=True)
                del args
                torch.cuda.empty_cache()
                continue
            results[row] = ms
            print(f"{row:44s} {ms:10.3f} ms", flush=True)
    return results


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "device cpu (host clock, not a device time)"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return f"device {torch.cuda.get_device_name(device)}; card: {card[0].strip()}"


def main(argv=None) -> int:
    from seld_tpu_torch import disable_tf32
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device=cpu to profile the plain versions")
    batch = int(os.environ.get("PROF_BATCH", "16"))
    sections = [s for s in os.environ.get("PROF_SECTIONS", DEFAULT_SECTIONS).split(",") if s]
    unknown = sorted(set(sections) - set(SECTIONS))
    if unknown:
        raise ValueError(f"PROF_SECTIONS: unknown {unknown}; known {sorted(SECTIONS)}")
    disable_tf32()
    print(f"{device_line(device)}; batch={batch} sections={','.join(sections)}", flush=True)
    reset_launch_counts()
    results = run(sections, batch, device)
    print(json.dumps({"launch_counts": dict(launch_counts)}))
    return 1 if any(v is None for v in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
