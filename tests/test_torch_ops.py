"""seld_tpu_torch.ops against seld_tpu.ops.

Same inputs, made by numpy from a seed, go through the JAX function (x64)
and its port counterpart in float64; both compute the same sums in the same
precision, so they agree to 1e-12 relative to the output's magnitude. The
initializers draw from different random streams and are held to the JAX
package by their statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

from seld_tpu.ops import dual_quaternion as jdq
from seld_tpu.ops import hamilton as jh
from seld_tpu.ops import inits as jinits
from seld_tpu.ops import quaternion as jq
from seld_tpu_torch.ops import dual_quaternion as tdq
from seld_tpu_torch.ops import hamilton as th
from seld_tpu_torch.ops import inits as tinits
from seld_tpu_torch.ops import quaternion as tq

F64_TOL = 1e-12  # x max|ref|: float64 on both sides


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL * max(np.abs(want).max(), 1.0))


def _jax(fn, *args, **kw):
    with enable_x64(True):
        return np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args], **kw))


def _torch(fn, *args, **kw):
    return fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args],
              **kw).numpy()


@pytest.mark.parametrize("name,n,shape", [
    ("assemble_q_kernel", 4, (3, 2, 5)),
    ("assemble_q_kernel", 4, (2, 3)),
    ("assemble_dq_conv_kernel", 8, (3, 3, 2, 3)),
    ("assemble_dq_linear_kernel", 8, (4, 2)),
])
def test_hamilton_assembly_matches_jax(rng, name, n, shape):
    comps = rng.standard_normal((n, *shape))
    _close(_torch(getattr(th, name), comps), _jax(getattr(jh, name), comps))


def test_dq_linear_and_conv_tables_differ(rng):
    """The reference quirk: DQ linear is not the 1x1 DQ conv."""
    comps = rng.standard_normal((8, 2, 3))
    lin = _torch(th.assemble_dq_linear_kernel, comps)
    conv = _torch(th.assemble_dq_conv_kernel, comps[:, None])[0]
    assert np.abs(lin - conv).max() > 0.1


@pytest.mark.parametrize("kind", ["q", "dq"])
def test_hamilton_linear_matches_jax(rng, kind):
    n = 4 if kind == "q" else 8
    x = rng.standard_normal((2, 5, 3 * n))
    comps = rng.standard_normal((n, 3, 2))
    b = rng.standard_normal(2 * n)
    jfn, tfn = ((jq.quaternion_linear, tq.quaternion_linear) if kind == "q"
                else (jdq.dual_quaternion_linear, tdq.dual_quaternion_linear))
    _close(_torch(tfn, x, comps, b), _jax(jfn, x, comps, b))


@pytest.mark.parametrize("kind,ndim,kw", [
    ("q", 1, dict(padding=2, dilation=2)),
    ("dq", 1, dict(padding=3, dilation=3)),
    ("q", 2, dict(padding=1)),
    ("dq", 2, dict(padding=(0, 1), stride=(1, 2))),
])
def test_hamilton_conv_matches_jax(rng, kind, ndim, kw):
    n = 4 if kind == "q" else 8
    x = rng.standard_normal((2, *([9] * ndim), 2 * n))
    comps = rng.standard_normal((n, *([3] * ndim), 2, 3))
    b = rng.standard_normal(3 * n)
    jfn, tfn = ((jq.quaternion_conv, tq.quaternion_conv) if kind == "q"
                else (jdq.dual_quaternion_conv, tdq.dual_quaternion_conv))
    _close(_torch(tfn, x, comps, b, **kw), _jax(jfn, x, comps, b, **kw))


def test_real_conv_nd_matches_jax(rng):
    x = rng.standard_normal((2, 11, 6))
    w = rng.standard_normal((3, 6, 4))
    _close(_torch(tq.conv_nd, x, w, None, padding=4, dilation=4),
           _jax(jq.conv_nd, x, w, None, padding=4, dilation=4))


def _moments(a):
    a = np.asarray(a, np.float64)
    return np.array([a.mean(), a.std(), np.abs(a).mean()])


@pytest.mark.parametrize("n,weight_init,criterion", [
    (4, "quaternion", "glorot"),
    (8, "quaternion", "glorot"),
    (4, "unitary", "he"),
    (4, "random", "he"),
])
def test_component_init_statistics(n, weight_init, criterion):
    """Per component: same mean, std and mean |w| as the JAX draw within 5%
    of the std (65536 draws each: sampling noise ~0.5%)."""
    shape = (3, 128, 64)
    gen = torch.Generator().manual_seed(0)
    got = tinits.component_init(shape, gen, n, weight_init, criterion).numpy()
    want = np.asarray(jinits.component_init(jax.random.PRNGKey(0), shape, n, weight_init,
                                            criterion))
    assert got.shape == want.shape == (n, *shape)
    for c in range(n):
        m_got, m_want = _moments(got[c]), _moments(want[c])
        np.testing.assert_allclose(m_got, m_want, atol=0.05 * m_want[1])


@pytest.mark.parametrize("kind", ["he_uniform", "lecun_normal"])
def test_flax_initializer_statistics(kind):
    shape = (3, 64, 96) if kind == "he_uniform" else (256, 128)
    gen = torch.Generator().manual_seed(0)
    got = getattr(tinits, kind)(shape, gen).numpy()
    init = (jax.nn.initializers.he_uniform(in_axis=-2, out_axis=-1) if kind == "he_uniform"
            else jax.nn.initializers.lecun_normal())
    want = np.asarray(init(jax.random.PRNGKey(0), shape))
    np.testing.assert_allclose(_moments(got), _moments(want), atol=0.05 * want.std())
    assert np.abs(got).max() <= np.abs(want).max() * 1.05   # same support / truncation
