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


# ---- K8's operands: the transposed, zero-padded weight and the row tile ------

from seld_tpu_torch.ops.kernels import quant as k8   # noqa: E402


def kernel_operands(x: torch.Tensor, w_q: torch.Tensor):
    """What K8's first launch writes, built on the CPU: x zero-padded to
    padded_k(Cin) columns and the weight as (Cout, padded_k(Cin)), each
    output column's k contiguous and zero past Cin."""
    cin, cout = w_q.shape
    k_pad = k8.padded_k(cin)
    w_t = torch.zeros((cout, k_pad), dtype=torch.int8)
    w_t[:, :cin] = w_q.t()
    return torch.nn.functional.pad(x, (0, k_pad - cin)), w_t


@pytest.mark.parametrize("cin", [1, 30, 32, 33, 48, 384])
def test_padded_k_is_the_next_multiple_of_the_k_step(cin):
    k_pad = k8.padded_k(cin)
    assert k_pad % k8.K_STEP == 0 and cin <= k_pad < cin + k8.K_STEP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(30, 16), (48, 80), (384, 384)])
def test_int8_matmul_on_the_padded_operands_is_bit_equal(rng, dtype, cin, cout):
    """The kernel's operands (x zero-padded to k_pad columns, the weight
    transposed and zero-padded) through the plain version: bit-equal to the
    unpadded call (zero k changes neither a row's |max| nor the exact sum)
    and to the Pallas ``int8_matmul`` in interpret mode. Cout is a multiple
    of 8 here: XLA on the CPU contracts the epilogue into one fma in its
    vector loops only, and at Cout 7 rounds some elements twice."""
    m = 70
    x = rng.standard_normal((m, cin)) * rng.uniform(0.01, 10.0, (m, 1))
    x[3] = 0.0
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = x.astype(np.float32).astype(np_dt)
    w = rng.standard_normal((cin, cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32).astype(np_dt)
    jq, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js, jnp.asarray(b),
                                         interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x.astype(np.float32)).to(tdt)
    bt = torch.from_numpy(b.astype(np.float32)).to(tdt)
    q, s = quantize_weight_per_channel(torch.from_numpy(w))
    x_pad, w_t = kernel_operands(xt, q)
    assert np.array_equal(w_t.numpy()[:, :cin], q.numpy().T) and not w_t.numpy()[:, cin:].any()
    padded = int8_matmul_plain(x_pad, w_t.t(), s, bt).float().numpy()
    unpadded = int8_matmul_plain(xt, q, s, bt).float().numpy()
    assert np.array_equal(padded, unpadded)
    assert np.array_equal(padded, want)
    assert np.array_equal(padded[3], b.astype(np.float32))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 600, 4800, 9600])
@pytest.mark.parametrize("cin,cout", [(384, 384), (384, 80), (30, 7), (4096, 384)])
def test_row_tile_covers_every_row_once(m, cin, cout):
    """The H100's 132 SMs: 64-row blocks where the grid's ceil(M / 64) row
    tiles x ceil(Cout / 128) column passes fill them (Cout 384: M 4800 and
    9600), else 32 (M 600: 57 blocks, not 15); 32 wherever 64 rows do not
    fit shared memory (Cin 4096). Row tiles cover rows [i * tile, (i + 1) *
    tile) and passes the columns, each once, in shared memory that fits."""
    tile = k8.row_tile(m, cin, cout, 132)
    passes = -(-cout // 128)
    assert tile == (64 if cin <= 3008 and -(-m // 64) * passes >= 132 else 32)
    assert k8.smem_bytes(tile, cin) <= k8.SMEM_BYTES
    blocks = -(-m // tile)
    rows = np.concatenate([np.arange(i * tile, min((i + 1) * tile, m)) for i in range(blocks)])
    assert np.array_equal(rows, np.arange(m))
    cols = np.concatenate([np.arange(j * 128, min((j + 1) * 128, cout)) for j in range(passes)])
    assert np.array_equal(cols, np.arange(cout))


def test_row_tile_where_shared_memory_runs_out():
    """64 rows fit up to Cin 3008 (k_pad 3008), 32 from 3009 (k_pad 3040)
    to 6080, then no tile fits and the wrapper raises."""
    assert k8.row_tile(9600, 3008, 384, 132) == 64 and k8.row_tile(9600, 3009, 384, 132) == 32
    assert k8.row_tile(9600, 6080, 384, 132) == 32
    assert k8.smem_bytes(64, 3009) > k8.SMEM_BYTES >= k8.smem_bytes(32, 6080)
    with pytest.raises(ValueError):
        k8.row_tile(9600, 6081, 384, 132)


def test_int8_matmul_on_the_cpu_is_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
    w_q, w_s = quantize_weight_per_channel(torch.from_numpy(
        rng.standard_normal((40, 24)).astype(np.float32)))
    assert torch.equal(int8_matmul(x, w_q, w_s), int8_matmul_plain(x, w_q, w_s))
