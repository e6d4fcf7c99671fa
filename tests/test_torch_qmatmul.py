"""K7's plain version and autograd Function against
``seld_tpu/ops/pallas/qmatmul.py`` (``pallas_q_linear``, ``pallas_dq_linear``
with both tables) under ``pltpu.force_tpu_interpret_mode()``, on the CPU,
forward and ``jax.grad``.

Tolerances: float32 1e-5 x max|ref| (the JAX package's own bound for the
kernel against XLA), bfloat16 2^-8 x max|ref| (one bf16 rounding of the
output: both sides sum the same bf16 products in float32, in another
order); gradients at atol 1e-4, rtol 1e-5 as ``tests/test_pallas.py``.
Inputs are drawn by numpy from a seed and fed to both sides.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from seld_tpu.ops.pallas import qmatmul as jqm
from seld_tpu_torch.ops.hamilton import assemble_hamilton
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.qmatmul import (
    hamilton_matmul, hamilton_matmul_plain, pallas_dq_linear, pallas_q_linear, structured_dw,
)

# (name, n, the port's op, the JAX op): the three orientations
OPS = [
    ("q", 4, lambda x, c, b: pallas_q_linear(x, c, b), lambda x, c, b: jqm.pallas_q_linear(x, c, b)),
    ("dq_linear", 8, lambda x, c, b: pallas_dq_linear(x, c, b),
     lambda x, c, b: jqm.pallas_dq_linear(x, c, b)),
    ("dq_conv", 8, lambda x, c, b: pallas_dq_linear(x, c, b, conv_table=True),
     lambda x, c, b: jqm.pallas_dq_linear(x, c, b, conv_table=True)),
]
IDS = [o[0] for o in OPS]


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain version: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _jax_fwd(fn, x, comps, b):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x), jnp.asarray(comps),
                             None if b is None else jnp.asarray(b))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(37,), (2, 9)], ids=["2d", "3d"])
@pytest.mark.parametrize("name,n,port_op,jax_op", OPS, ids=IDS)
def test_forward_matches_the_pallas_op(rng, dtype, lead, name, n, port_op, jax_op):
    """cin_c 3, cout_c 5: the Hamilton blocks do not line up with anything."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = rng.standard_normal((*lead, n * 3)).astype(np.float32).astype(np_dt)
    comps = rng.standard_normal((n, 3, 5)).astype(np.float32).astype(np_dt)
    b = rng.standard_normal(n * 5).astype(np.float32).astype(np_dt)
    tdt = getattr(torch, dtype)
    to_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(tdt)
    for bias in (b, None):
        want = _jax_fwd(jax_op, x, comps, bias)
        got = port_op(to_t(x), to_t(comps), None if bias is None else to_t(bias))
        assert got.dtype == tdt and got.shape == want.shape
        tol = (1e-5 if dtype == "float32" else 2.0 ** -8) * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("name,n,port_op,jax_op,cin_c,cout_c", [
    (*OPS[0], 5, 16),    # K = 20: K % 8 != 0 (the bf16 kernel's 2-byte x loads)
    (*OPS[1], 3, 16),    # K = 24: K % 16 != 0 (a zero-filled k16 step)
    (*OPS[2], 6, 10),    # cout_c % 8 != 0 (the weight assembled element by element)
    (*OPS[0], 96, 24),   # the Q configs' cin_c
], ids=["q-k20", "dq_linear-k24", "dq_conv-n10", "q-cin96"])
def test_forward_at_the_tensor_core_kernels_widths(rng, name, n, port_op, jax_op, cin_c,
                                                   cout_c):
    """bfloat16 at the widths that steer the bf16 kernel's staging paths
    (tests/test_torch_cuda.py::K7_CASES), 67 rows: the plain version the
    kernel is held to on the card, against the Pallas op."""
    bf = ml_dtypes.bfloat16
    x = rng.standard_normal((67, n * cin_c)).astype(np.float32).astype(bf)
    comps = (rng.standard_normal((n, cin_c, cout_c)) / cin_c ** 0.5).astype(np.float32).astype(bf)
    b = rng.standard_normal(n * cout_c).astype(np.float32).astype(bf)
    want = _jax_fwd(jax_op, x, comps, b)
    to_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    got = port_op(to_t(x), to_t(comps), to_t(b))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("name,n,port_op,jax_op", OPS, ids=IDS)
def test_gradients_match_jax_grad(rng, name, n, port_op, jax_op):
    x = rng.standard_normal((12, n * 2)).astype(np.float32)
    comps = rng.standard_normal((n, 2, 3)).astype(np.float32)
    b = rng.standard_normal(n * 3).astype(np.float32)

    def loss(x_, c_, b_):
        return jnp.sum(jax_op(x_, c_, b_) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, comps, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, comps, b)]
    (port_op(*leaves) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n,linear_table", [(4, False), (4, True), (8, False), (8, True)])
def test_structured_dw_is_the_gradient_of_the_assembly(rng, n, linear_table):
    """structured_dw(G) equals autograd of <assemble(comps), G> (float64)."""
    comps = torch.from_numpy(rng.standard_normal((n, 3, 2))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((n * 3, n * 2)))
    (assemble_hamilton(comps, linear_table) * g).sum().backward()
    np.testing.assert_allclose(structured_dw(g, 3, 2, n, linear_table).numpy(),
                               comps.grad.numpy(), rtol=0, atol=1e-12)


def test_wrapper_takes_the_plain_version_and_checks_shapes(rng):
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    comps = torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(np.float32))
    assert torch.equal(hamilton_matmul(x, comps, None, 4, False),
                       hamilton_matmul_plain(x, comps, None, 4, False))
    with pytest.raises(ValueError):
        hamilton_matmul(x, comps, None, 8, False)
    with pytest.raises(ValueError):
        hamilton_matmul(x[:, :6], comps, None, 4, False)
