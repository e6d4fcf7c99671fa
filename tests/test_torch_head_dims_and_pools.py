"""Two entry limits the port's kernels had and the JAX kernels lack, closed.

- K4 / K6 take any head dim: the wrappers zero-pad D to the next
  instantiated dim, or past 128 to the next multiple of 32 in column groups
  of at most 256 (bfloat16's wide kernels and float32's, in split TF32), as
  ``attention.head_dim_plan`` gives, with ``pad_heads``, and slice the
  outputs back. The plan covers every column once, pads by less than 32 and
  groups no wider than 256 (exact integers). Here the padding runs
  through the plain versions (the CPU path of the kernels) at D 8, 24, 136,
  160, 192, 300 and 320 to the padded D and is held to the
  unpadded plain
  version (float64, 1e-12 x max|ref|: zero columns add exact zeros, only
  the summation's blocking may differ) and to the JAX ``flash_attention`` in
  interpret mode (float32, 2e-4 x max|ref|, as tests/test_torch_train_kernels.py
  holds K6), forward and gradients.
- K2's entry takes any pool_f dividing F: the kernel stages the window's
  rows in chunks of ``smallcin_max_pool_f`` rows
  (``conv2d_pool.smallcin_pool_chunks``, whose rows per chunk the wrapper
  hands the kernel), each pool row exactly once.
- The port's ``fused_infer`` at tiny configs whose attention head dim is 8,
  24 and 160 (V[0] = 64, 192 and 1280, 8 heads; otherwise
  tests/test_torch_fused_infer.py's slice) against the JAX package's,
  float32, 1e-4 as that file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.models.fused_infer import fused_infer as jax_fused_infer
from seld_tpu.ops.pallas.attention import flash_attention as jflash
from seld_tpu.ops.pallas.stft import stft_mag_pallas
from seld_tpu_torch.models.fused_infer import fused_infer
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import conv2d_pool as pool
from seld_tpu_torch.ops.kernels.attention import (
    HEAD_DIMS, WIDE_GROUPS, flash_attention_bwd_plain, flash_attention_plain,
    head_dim_plan, pad_heads,
)
from seld_tpu_torch.ops.kernels.stft import stft_mag
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.test_torch_fused_infer import N_SAMPLES
from tests.test_torch_model import random_variables, tiny_config

F64_TOL, F32_TOL = 1e-12, 2e-4


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_padded_head_dim_is_the_next_instantiation():
    pads = lambda dims, dt: [head_dim_plan(d, dt)[0] for d in dims]
    for dt in (torch.float32, torch.bfloat16):
        assert pads((1, 8, 16, 24, 40, 48, 49, 96, 128), dt) == [
            16, 16, 16, 32, 48, 48, 64, 128, 128]
        assert all(head_dim_plan(d, dt) == (d, d) for d in HEAD_DIMS)
    # past 128, both dtypes: the next multiple of 32 (the JAX kernel pads D to
    # a multiple of 128, a TPU lane rule)
    for dt in (torch.float32, torch.bfloat16):
        assert pads((129, 160, 256, 257, 300, 320, 384), dt) == [
            160, 160, 256, 288, 320, 320, 384]
        assert pads((136, 200, 512, 513), dt) == [160, 224, 512, 544]


def plan_groups(d_pad: int, width: int) -> list:
    """[start, stop) output columns of each group, as the kernels' dispatch
    derives them from (d_pad, width): ceil(d_pad / width) blocks on grid z,
    block z owning [z width, min((z + 1) width, d_pad))."""
    return [(c, min(c + width, d_pad)) for c in range(0, d_pad, width)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_plan_covers_every_column_once(dtype):
    """Every column of d_pad in exactly one group, in order; past 128, in
    both dtypes: d_pad - D < 32, one group up to 256 and ceil(d_pad / 256)
    past it, the width one the wide kernels are built for (so no group is
    wider than 256; the last may be narrower, a multiple of 32); D <= 128:
    one group of the next instantiated dim."""
    for d in range(1, 2561):
        d_pad, width = head_dim_plan(d, dtype)
        groups = plan_groups(d_pad, width)
        cols = [c for c0, c1 in groups for c in range(c0, c1)]
        assert cols == list(range(d_pad)) and d_pad >= d
        widths = [c1 - c0 for c0, c1 in groups]
        if d <= 128:
            assert groups == [(0, d_pad)] and d_pad in HEAD_DIMS
        else:
            assert d_pad % 32 == 0 and d_pad - d < 32
            assert len(groups) == -(-d_pad // 256)
            assert width in WIDE_GROUPS and widths[-1] % 32 == 0


@pytest.mark.parametrize("d,d_pad,widths", [
    (288, 288, [160, 128]), (300, 320, [160, 160]), (480, 480, [256, 224]),
    (600, 608, [224, 224, 160]), (640, 640, [224, 224, 192]), (1280, 1280, [256] * 5)])
def test_head_dim_plan_groups_at_the_card_tests_dims(d, d_pad, widths):
    """The groups (both dtypes) of the head dims the card tests run past 256,
    among them those whose last group is narrower (288, 480, 600, 640)."""
    for dtype in (torch.bfloat16, torch.float32):
        got_pad, width = head_dim_plan(d, dtype)
        assert got_pad == d_pad
        assert [c1 - c0 for c0, c1 in plan_groups(got_pad, width)] == widths


@pytest.mark.parametrize("d", [8, 24, 136, 160, 192, 300, 320])
def test_padded_attention_matches_unpadded_and_jax(rng, d):
    b, t, h = 2, 70, 3
    q, k, v, g = (rng.standard_normal((b, t, h, d)) for _ in range(4))
    scale = d ** -0.5
    q64, k64, v64, g64 = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_attention_plain(q64, k64, v64, scale)
    grads = flash_attention_bwd_plain(q64, k64, v64, out, g64, lse, scale)
    # both dtypes' padded D (past 128: a multiple of 32)
    for dp in sorted({head_dim_plan(d, dt)[0] for dt in (torch.bfloat16, torch.float32)}):
        qp, kp, vp = pad_heads(dp, q64, k64, v64)
        assert qp.shape == (b, t, h, dp) and torch.equal(qp[..., :d], q64)
        assert not qp[..., d:].any()
        out_p, lse_p = flash_attention_plain(qp, kp, vp, scale)
        _close(out_p[..., :d], out, F64_TOL)
        _close(lse_p, lse, F64_TOL)
        # the backward on the padded operands, sliced back
        grads_p = flash_attention_bwd_plain(qp, kp, vp, *pad_heads(dp, out_p, g64), lse_p, scale)
        for a, w_ in zip(grads_p, grads):
            _close(a[..., :d], w_, F64_TOL)
    # against the Pallas kernel in interpret mode, float32, from the bf16 plan's padding
    dp = head_dim_plan(d, torch.bfloat16)[0]
    qp, kp, vp = pad_heads(dp, q64, k64, v64)
    out_p, lse_p = flash_attention_plain(qp, kp, vp, scale)
    grads_p = flash_attention_bwd_plain(qp, kp, vp, *pad_heads(dp, out_p, g64), lse_p, scale)
    want, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, scale, block_q=32, block_k=32,
                                                interpret=True),
                        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    _close(out_p[..., :d].numpy(), want, F32_TOL)
    for a, w_ in zip(grads_p, vjp(jnp.asarray(g, jnp.float32))):
        _close(a[..., :d].numpy(), w_, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_f", [64, 128, 256])
def test_smallcin_pool_chunks_cover_each_row_once(pool_f, dtype):
    step = pool.smallcin_max_pool_f(8, dtype)
    chunks = pool.smallcin_pool_chunks(pool_f, 8, dtype)
    rows = [r0 + i for r0, n in chunks for i in range(n)]
    assert rows == list(range(pool_f))
    assert all(1 <= n <= step for _, n in chunks)
    assert len(chunks) == -(-pool_f // step)
    assert pool.smallcin_pool_chunks(step, 8, dtype) == [(0, step)]


@pytest.mark.parametrize("v0,head_dim", [(64, 8), (192, 24), (1280, 160)])
def test_fused_infer_at_small_head_dims_matches_jax(rng, v0, head_dim):
    cfg = tiny_config(freq_dim=256, time_dim=32, cnn_filters=[8, 16, 16],
                      pool_size=[[8, 2], [8, 2], [2, 2]], D=[3], G=16, U=16, V=[v0, 16],
                      domain_classifier="DQ")
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, 8, 256, 32), rng, dtype=np.float32)
    audio = rng.standard_normal((2, 8, N_SAMPLES)).astype(np.float32)
    featurize = lambda a: stft_mag_pallas(a, out_dtype=jnp.float32, interpret=True)
    sed_ref, doa_ref = jax.jit(lambda v, a: jax_fused_infer(
        jmodel, v, a, interpret=True, input_layout="BCTF", featurize=featurize,
    ))(variables, jnp.asarray(audio))

    model = model_from_config(cfg)
    from_jax_variables(variables, model)
    attention = model.seld_block.tcn.attention
    assert attention.embed_size // attention.num_heads == head_dim
    sed, doa = fused_infer(model, torch.from_numpy(audio), input_layout="BCTF",
                           featurize=lambda a: stft_mag(a, out_dtype=torch.float32))
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-4)
