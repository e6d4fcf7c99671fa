"""K8's plain version and the weight quantization of the port against
``seld_tpu/ops/pallas/quant.py`` on the CPU.

``int8_matmul_plain`` must equal ``int8_matmul(..., interpret=True)`` bit for
bit (``np.array_equal``): it writes the arithmetic the JAX kernel performs
as XLA compiles it (``ops/kernels/quant.py``). Inputs are drawn by numpy
from a seed and fed to both sides.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from seld_tpu.ops.hamilton import (
    assemble_dq_conv_kernel, assemble_dq_linear_kernel, assemble_q_kernel,
)
from seld_tpu.ops.pallas import quant as jquant
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.quant import (
    int8_matmul, int8_matmul_plain, quantize_hamilton, quantize_weight_per_channel,
)

# (n, linear_table, the JAX assembly of that orientation)
TABLES = [(4, False, assemble_q_kernel), (8, False, assemble_dq_conv_kernel),
          (8, True, assemble_dq_linear_kernel)]


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain version: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def test_weight_quantization_equals_the_jax_package(rng):
    w = (rng.standard_normal((48, 40)) * 3).astype(np.float32)
    w[:, 5] = 0.0   # an all-zero channel: scale 1
    q, s = quantize_weight_per_channel(torch.from_numpy(w))
    jq, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("n,linear_table,assemble", TABLES, ids=["q", "dq_conv", "dq_linear"])
def test_quantize_hamilton_equals_the_jax_package(rng, n, linear_table, assemble):
    comps = rng.standard_normal((n, 6, 5)).astype(np.float32)
    q, s = quantize_hamilton(torch.from_numpy(comps), linear_table)
    jq, js = jquant.quantize_hamilton(jnp.asarray(comps), assemble)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,linear_table,assemble", TABLES, ids=["q", "dq_conv", "dq_linear"])
def test_int8_matmul_plain_is_bit_equal_to_the_pallas_kernel(rng, dtype, n, linear_table,
                                                             assemble):
    """M = 300 rows (the JAX kernel pads to its 304-row tile), Cin = Cout =
    n * 12, a zero row (amax = 0) and rows of mixed scale; the bias rounded
    to x's dtype first, as the layers pass it."""
    m, c = 300, n * 12
    comps = rng.standard_normal((n, 12, 12)).astype(np.float32)
    x = rng.standard_normal((m, c)) * rng.uniform(0.01, 10.0, (m, 1))
    x[7] = 0.0
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = x.astype(np.float32).astype(np_dt)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32).astype(np_dt)
    jq, js = jquant.quantize_hamilton(jnp.asarray(comps), assemble)
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js, jnp.asarray(b),
                                         interpret=True))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x.astype(np.float32)).to(tdt)
    bt = torch.from_numpy(b.astype(np.float32)).to(tdt)
    q, s = quantize_hamilton(torch.from_numpy(comps), linear_table)
    got = int8_matmul_plain(xt, q, s, bt)
    assert got.dtype == tdt and got.shape == (m, c)
    got = got.float().numpy()
    want = want.astype(np.float32)
    assert np.array_equal(got, want), (
        f"{int((got != want).sum())} of {got.size} differ, max |d| {np.abs(got - want).max()}")
    # the zero row is the bias alone
    assert np.array_equal(got[7], b.astype(np.float32))


def test_int8_matmul_takes_leading_dims_and_no_bias(rng):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    jq, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js, None, interpret=True))
    q, s = quantize_weight_per_channel(torch.from_numpy(w))
    got = int8_matmul(torch.from_numpy(x), q, s)
    assert got.shape == (2, 5, 8)
    assert np.array_equal(got.numpy(), want)


def test_int8_matmul_rejects_what_it_does_not_take():
    x = torch.zeros(3, 8)
    with pytest.raises(TypeError):
        int8_matmul(x, torch.zeros(8, 4), torch.ones(4))
    with pytest.raises(ValueError):
        int8_matmul(x, torch.zeros(6, 4, dtype=torch.int8), torch.ones(4))
