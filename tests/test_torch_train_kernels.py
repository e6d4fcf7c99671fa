"""The training path's kernel ops, through their plain versions (the CPU path
of each wrapper), against the JAX package.

- K5: ``conv2d_bn_relu_fpool_train`` against
  ``seld_tpu/ops/pallas/conv2d_train.py::conv2d_smallcin_bn_relu_fpool_train``
  in interpret mode (float32 at HIGHEST precision; the thin pack for Cin
  <= 8, the wide pack for Cin 9 and 10, the reference's 3 * Cin <= 32): out,
  mean, var, and dW / dgamma / dbeta from ``jax.vjp``, 2e-4 x max|ref|, with
  cases of Cout not a multiple of 8 and a ragged T; B2 is the g_z pass and
  the dW tile in every dtype, held to B2 as one function
  (``conv_train_dw_plain``), and the op in float32 to ``jax.vjp`` as well.
- K6: ``flash_attention_train``'s backward against ``jax.vjp`` of the Pallas
  ``flash_attention`` in interpret mode (float32, 2e-4 x max|ref|) and
  against torch autograd of ``attend_full`` (float64, 1e-12 x max|ref|).

Inputs are drawn by numpy from a seed and fed to both sides. The port's
side gets them widened to float64, so its products are exact on every host
(a host's float32 CPU GEMM may be less accurate than the bound assumes; see
``tests/test_torch_kernels.py``); the plain versions' float32 branch is the
same code and is held to the kernels on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.ops.pallas.attention import flash_attention as jflash
from seld_tpu.ops.pallas.conv2d_train import conv2d_smallcin_bn_relu_fpool_train as jk5
from seld_tpu_torch.models.attention import attend_full
from seld_tpu_torch.ops.kernels import conv2d_train as k5
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels.attention import HEAD_DIMS, flash_attention_train

F32_TOL = 2e-4  # x max|ref|


def _close(got, want, tol=F32_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _k5_case(rng, b, f, t, cin, cout, pf):
    x = rng.standard_normal((b, f, t, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(cout)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    probe = rng.standard_normal((b, f // pf, t, cout)).astype(np.float32)
    return x, w, gamma, beta, probe


def _port_k5(fn, x, w, gamma, beta, probe, pf):
    """The op and its gradients on float64 copies of the inputs."""
    x, w, gamma, beta, probe = (torch.from_numpy(a).double() for a in (x, w, gamma, beta, probe))
    wt, gt, bt = (a.requires_grad_() for a in (w, gamma, beta))
    out, mean, var = fn(x, wt, gt, bt, pf)
    (out * probe).sum().backward()
    return [t.detach().numpy() for t in (out, mean, var, wt.grad, gt.grad, bt.grad)]


@pytest.mark.parametrize("b,f,t,cin,cout,pf", [(2, 16, 40, 8, 16, 8),
                                               (2, 16, 33, 5, 12, 8),
                                               (2, 8, 21, 9, 12, 4),
                                               (1, 16, 33, 10, 16, 8)])
def test_k5_plain_matches_pallas_train_op(rng, b, f, t, cin, cout, pf):
    x, w, gamma, beta, probe = _k5_case(rng, b, f, t, cin, cout, pf)

    def jfn(w_, g_, b_):
        return jk5(jnp.asarray(x), w_, g_, b_, pf, 1e-5, True, jax.lax.Precision.HIGHEST,
                   pack="thin" if cin <= 8 else "wide")

    (out, mean, var), vjp = jax.vjp(jfn, *map(jnp.asarray, (w, gamma, beta)))
    dw, dgamma, dbeta = vjp((jnp.asarray(probe), jnp.zeros_like(mean), jnp.zeros_like(var)))
    want = [out, mean, var, dw, dgamma, dbeta]
    got = _port_k5(k5.conv2d_bn_relu_fpool_train, x, w, gamma, beta, probe, pf)
    for name, g_, w_ in zip(("out", "mean", "var", "dw", "dgamma", "dbeta"), got, want):
        assert np.isfinite(g_).all(), name
        _close(g_, w_)


@pytest.mark.parametrize("b,f,t,cin,cout,pf", [(2, 16, 40, 8, 16, 8), (1, 16, 33, 10, 16, 8)])
def test_k5_float32_op_matches_pallas_vjp(rng, monkeypatch, b, f, t, cin, cout, pf):
    """The op on float32 tensors (its CPU path: the plain versions of F1,
    F2, B1, the g_z pass and the dW tile, in float32) against jax.vjp of the
    Pallas op in interpret mode (float32, HIGHEST): out, mean, var, dW,
    dgamma and dbeta at 2e-4 x max|ref|; B2 goes through the g_z pass and
    the dW tile."""
    calls = []
    for name in ("conv_train_gz", "conv_train_dw_gz"):
        fn = getattr(k5, name)
        monkeypatch.setattr(k5, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x, w, gamma, beta, probe = _k5_case(rng, b, f, t, cin, cout, pf)

    def jfn(w_, g_, b_):
        return jk5(jnp.asarray(x), w_, g_, b_, pf, 1e-5, True, jax.lax.Precision.HIGHEST,
                   pack="thin" if cin <= 8 else "wide")

    (out, mean, var), vjp = jax.vjp(jfn, *map(jnp.asarray, (w, gamma, beta)))
    want = [out, mean, var, *vjp((jnp.asarray(probe), jnp.zeros_like(mean),
                                  jnp.zeros_like(var)))]
    wt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, gamma, beta))
    res = k5.conv2d_bn_relu_fpool_train(torch.from_numpy(x), wt, gt, bt, pf)
    (res[0] * torch.from_numpy(probe)).sum().backward()
    got = [a.detach().numpy() for a in (*res, wt.grad, gt.grad, bt.grad)]
    assert calls == ["conv_train_gz", "conv_train_dw_gz"]
    for name, g_, w_ in zip(("out", "mean", "var", "dw", "dgamma", "dbeta"), got, want):
        assert g_.dtype == np.float32 and np.isfinite(g_).all(), name
        _close(g_, w_)


def test_k5_backward_matches_autograd_of_the_plain_op(rng):
    """The hand-derived backward (B1 recovery, B2 routing, subtract-before-dot)
    against torch autograd of the plain composition, float64."""
    x, w, gamma, beta, probe = _k5_case(rng, 2, 24, 37, 5, 20, 4)
    got = _port_k5(k5.conv2d_bn_relu_fpool_train, x, w, gamma, beta, probe, 4)
    want = _port_k5(k5.conv2d_bn_relu_fpool_train_plain, x, w, gamma, beta, probe, 4)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 1e-12)


# (b, f, t, cin, cout, pf): Cin 5 / 8 / 10, F 16-24 with pool 4 and 8, T not a
# multiple of 64
K5_TC_CASES = [(2, 16, 37, 5, 12, 4), (2, 24, 45, 8, 16, 8), (2, 16, 70, 10, 12, 8)]


@pytest.mark.parametrize("b,f,t,cin,cout,pf", K5_TC_CASES)
def test_k5_bf16_passes_match_pallas_train_op(rng, monkeypatch, b, f, t, cin, cout, pf):
    """bfloat16's split B2 (conv_train_gz's routing, g_z and routed sums, then
    conv_train_dw_gz, i.e. conv2d_weight(x, g_z)) through the op, run on
    float64 inputs by forcing the tensor-core route, against jax.vjp of the
    Pallas op in interpret mode: out, mean, var, dW, dgamma, dbeta at 2e-4 x
    max|ref|."""
    monkeypatch.setattr(k5, "tensor_core_path", lambda x: True)
    calls = []
    for name in ("conv_train_gz", "conv_train_dw_gz"):
        fn = getattr(k5, name)
        monkeypatch.setattr(k5, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x, w, gamma, beta, probe = _k5_case(rng, b, f, t, cin, cout, pf)

    def jfn(w_, g_, b_):
        return jk5(jnp.asarray(x), w_, g_, b_, pf, 1e-5, True, jax.lax.Precision.HIGHEST,
                   pack="thin" if cin <= 8 else "wide")

    (out, mean, var), vjp = jax.vjp(jfn, *map(jnp.asarray, (w, gamma, beta)))
    dw, dgamma, dbeta = vjp((jnp.asarray(probe), jnp.zeros_like(mean), jnp.zeros_like(var)))
    got = _port_k5(k5.conv2d_bn_relu_fpool_train, x, w, gamma, beta, probe, pf)
    assert calls == ["conv_train_gz", "conv_train_dw_gz"]
    for name, g_, w_ in zip(("out", "mean", "var", "dw", "dgamma", "dbeta"), got,
                            [out, mean, var, dw, dgamma, dbeta]):
        assert np.isfinite(g_).all(), name
        _close(g_, w_)


# float64 at K5_TC_CASES (their ids as before), and float32 at Cin 5 and 8
GZ_DW_CASES = [(*c, torch.float64) for c in K5_TC_CASES] + [
    (2, 16, 37, 5, 12, 4, torch.float32), (2, 24, 45, 8, 16, 8, torch.float32)]
GZ_DW_IDS = ["-".join(map(str, c[:6])) + ("" if c[6] == torch.float64 else "-float32")
             for c in GZ_DW_CASES]


@pytest.mark.parametrize("b,f,t,cin,cout,pf,dtype", GZ_DW_CASES, ids=GZ_DW_IDS)
def test_k5_gz_pass_and_dw_tile_equal_the_fused_b2(rng, b, f, t, cin, cout, pf, dtype):
    """conv_train_gz_plain + dw_plain give B2 as one function
    (conv_train_dw_plain): dW, S_g and sum g_pre * acc, 1e-12 x max|ref| in
    float64 and 1e-6 in float32 (the same sums, so equal but for the order
    of the float32 ones); g_z is (B, Cout, F, T) in x's dtype."""
    x, w, _, _, _ = _k5_case(rng, b, f, t, cin, cout, pf)
    xc = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(w).to(dtype)
    col = lambda s_: torch.from_numpy(s_ * rng.standard_normal(cout)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((b, cout, f // pf, t))).to(dtype)
    scale, bias, a, c = 1.0 + col(0.2), col(0.2), col(1e-2), col(1e-2)
    gz, sums = k5.conv_train_gz(xc, wt, g, scale, bias, a, c, pf)
    assert gz.shape == (b, cout, f, t) and gz.dtype == dtype
    fused = k5.conv_train_dw_plain(xc, wt, g, scale, bias, a, c, pf).numpy()
    kd = k5.kdim(cin)
    want_dw = fused[:cout * kd].reshape(cout, 3, 3, kd // 9)[..., :cin].transpose(1, 2, 3, 0)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    _close(k5.conv_train_dw_gz(xc, gz).numpy(), want_dw, tol)
    _close(sums.numpy(), fused[cout * kd:], tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_routes_b2_by_dtype(monkeypatch, dtype):
    """Both dtypes take B2 as two passes (on CPU tensors their plain
    versions): the g_z pass, then the dW tile; no fused float32 B2 is left
    to fall back to. The forward's F1 / F2 route depends on the dtype alone
    (tensor_core_path)."""
    assert k5.tensor_core_path(torch.zeros(1, dtype=dtype)) == (dtype == torch.bfloat16)
    assert not k5.tensor_core_path(torch.zeros(1, dtype=torch.float64))
    assert not hasattr(k5, "conv_train_dw")
    calls = []
    for name in ("conv_train_gz", "conv_train_dw_gz"):
        fn = getattr(k5, name)
        monkeypatch.setattr(k5, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 21, 8, generator=gen).to(dtype)
    w = (0.2 * torch.randn(3, 3, 8, 12, generator=gen)).to(dtype).requires_grad_()
    gamma, beta = torch.ones(12, requires_grad=True), torch.zeros(12, requires_grad=True)
    out, _, _ = k5.conv2d_bn_relu_fpool_train(x, w, gamma, beta, 4)
    out.float().sum().backward()
    assert calls == ["conv_train_gz", "conv_train_dw_gz"]
    assert w.grad.dtype == dtype and bool(torch.isfinite(w.grad).all())


def test_k5_dw_tile_takes_one_16_channel_tile():
    """conv_train_dw_gz takes Cin <= 16 (the 16-channel Cin tile) and one B,
    F and T for x and g_z."""
    gz = torch.zeros(1, 4, 8, 10, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k5.conv_train_dw_gz(torch.zeros(1, 17, 8, 10, dtype=torch.bfloat16), gz)
    with pytest.raises(ValueError):
        k5.conv_train_dw_gz(torch.zeros(1, 8, 8, 12, dtype=torch.bfloat16), gz)
    assert k5.conv_train_dw_gz(torch.zeros(1, 8, 8, 10, dtype=torch.bfloat16),
                               gz).shape == (3, 3, 8, 4)


def test_k5_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 10, 11)   # Cin 11: 3 * Cin > 32
    w = torch.zeros(3, 3, 11, 4)
    s = torch.ones(4)
    with pytest.raises(ValueError):
        k5.conv2d_bn_relu_fpool_train(x, w, s, s, 2)
    with pytest.raises(ValueError):   # F = 8 does not divide into pool 3
        k5.conv2d_bn_relu_fpool_train(x[..., :8], w[:, :, :8], s, s, 3)
    x = torch.zeros(1, 256, 10, 10)
    with pytest.raises(ValueError):   # pool 256 > K5's 255 rows (the routed row's byte)
        k5.conv2d_bn_relu_fpool_train(x, w[:, :, :10], s, s, 256)


@pytest.mark.parametrize("cin", [1, 8, 9, 10])
def test_pool_f_limits_are_the_kernels_shared_memory(cin):
    """K2's float32 rows per halo staging are the largest whose shared
    memory, as conv3x3_smallcin_tf32.cuh sizes it (pool_f + 2 halo rows of
    CC x (128 + 8) floats beside the split weights, hi and lo planes of 9 x
    CC x 64 floats, and 4 x 64 floats of columns), fits 232,448 bytes; K5's
    float32 F1 and g_z pass walk the same stagings, so K5's largest pool_f
    is the g_z passes' routed row in a byte (255, the C entries' bound),
    above the 48 / 21 rows of the SIMT passes it replaced."""
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool

    cc = 8 if cin <= 8 else 16

    def fits(pf):
        return 4 * ((pf + 2) * cc * 136 + 2 * 9 * cc * 64 + 4 * 64) <= 232_448

    top = pool.smallcin_max_pool_f(cin)
    assert fits(top) and not fits(top + 1)
    assert top == (42 if cin <= 8 else 16)
    assert k5.max_pool_f(cin) == k5.MAX_POOL_ROWS == 255 >= (48 if cin <= 8 else 21)


def _stage0_block(cin, frontend_impl, n_stages=1):
    from seld_tpu_torch.models.blocks import ConvTCBlock

    return ConvTCBlock("R", cin, 8, [8] * n_stages, 3, [[2, 1]] * n_stages, "CNN", [1],
                       "fibonacci", 8, 8, 3, [8, 8], 3, use_bias=False, batch_norm="BN",
                       attention_impl="full", frontend_impl=frontend_impl,
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("frontend_impl", ["fused", "ct"])
@pytest.mark.parametrize("cin", [9, 10, 11])
def test_k5_gates_take_the_reference_range(frontend_impl, cin):
    """ConvTCBlock's K5 / K9 gates test 3 * Cin <= 32, as the reference's
    do: Cin 9 and 10 take the kernel ops (their plain versions on the CPU)
    without a warning; Cin 11 warns and runs the plain stages."""
    import warnings

    block = _stage0_block(cin, frontend_impl, n_stages=2)
    x = torch.randn(2, 8, 6, cin, generator=torch.Generator().manual_seed(1))
    gate = block._ct_train_ok if frontend_impl == "ct" else (
        lambda x_: block._fused_train_ok(x_, block.pools[0]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ok = gate(x)
    assert ok == (cin <= 10)
    assert bool(caught) == (cin > 10)


def _qkv(rng, b, t, h, d, dtype):
    return [rng.standard_normal((b, t, h, d)).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_backward_matches_pallas_vjp(rng, d):
    q, k, v, g = _qkv(rng, 2, 64, 3, d, np.float32)
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, scale, block_q=32, block_k=32,
                                                interpret=True),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v))
    got_out = flash_attention_train(qt, kt, vt, scale)
    (got_out * torch.from_numpy(g).double()).sum().backward()
    _close(got_out.detach().numpy(), out)
    for t_, w_ in zip((qt, kt, vt), want):
        _close(t_.grad.numpy(), w_)


def test_flash_backward_matches_autograd_of_full_attention(rng):
    q, k, v, g = _qkv(rng, 2, 37, 3, 16, np.float64)
    grads = []
    for fn in (flash_attention_train, attend_full):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts, 0.25) * torch.from_numpy(g)).sum().backward()
        grads.append([t.grad.numpy() for t in ts])
    for a, b_ in zip(*grads):
        _close(a, b_, 1e-12)
