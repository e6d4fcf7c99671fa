"""K2w, K10a and K10b: the port's packers and plain versions against the JAX
package's Pallas functions in interpret mode, and the serving stage's
four-way routing.

Inputs are made by numpy from a seed and fed to both sides; x is (B, Cin, F,
T) in the port and (B, F, T, Cin) for the JAX functions. Tolerances: float32
against Pallas, 1e-5 x max|want| (the same sums in another order, K <= 9 *
16); float64 plain against plain, 1e-12 relative. The CUDA kernels are held
to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.ops.pallas import conv2d_pool as jpool
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.ops.kernels import conv2d_pool as pool

F32_TOL = 1e-5   # x max|want|
F64_TOL = 1e-12  # x max|want|


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _inputs(rng, b, cin, f, t, cout, dtype=np.float32):
    x = rng.standard_normal((b, cin, f, t)).astype(dtype)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(dtype)
    scale = (1.0 + 0.3 * rng.standard_normal(cout)).astype(dtype)
    bias = (0.3 * rng.standard_normal(cout)).astype(dtype)
    return x, w, scale, bias


def _jax_args(x, w, scale, bias):
    return (jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), jnp.asarray(scale),
            jnp.asarray(bias))


def _close(got, want_ftc, tol=F32_TOL):
    """got (B, Cout, F', T) against the JAX functions' (B, F', T, Cout)."""
    want = np.asarray(want_ftc, np.float64).transpose(0, 3, 1, 2)
    got = got.double().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("t", [32, 100, 300])
@pytest.mark.parametrize("cin", [3, 5, 8, 10])
def test_smallcin_pack_equals_jax(rng, cin, t):
    """p0 and wk bit for bit: kg 16 for Cin 3 and 5, 32 for Cin 8 and 10."""
    x, w, _, _ = _inputs(rng, 2, cin, 6, t, 7)
    p0, wk = pool.smallcin_pack(torch.from_numpy(x), torch.from_numpy(w))
    jp0, jwk, meta = jpool.smallcin_pack(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w))
    kg, tpad = meta[5], meta[6]
    assert kg == pool.smallcin_kg(cin) == (16 if cin <= 5 else 32)
    assert p0.shape == (2, 8, kg, tpad) and wk.shape == (7, 3 * kg)
    assert np.array_equal(p0.numpy(), np.asarray(jp0))
    assert np.array_equal(wk.numpy(), np.asarray(jwk))


@pytest.mark.parametrize("t", [32, 100])
@pytest.mark.parametrize("pf", [2, 4, 8])
@pytest.mark.parametrize("cin", [4, 8, 10])
def test_smallcin_wide_plain_matches_pallas(rng, cin, pf, t):
    x, w, scale, bias = _inputs(rng, 2, cin, 16, t, 12)
    got = pool.conv2d_smallcin_wide_bn_relu_fpool(
        *map(torch.from_numpy, (x, w, scale, bias)), pf)
    want = jpool.conv2d_smallcin_bn_relu_fpool(*_jax_args(x, w, scale, bias), pool_f=pf,
                                               interpret=True)
    _close(got, want)


@pytest.mark.parametrize("cin", [1, 2, 3, 5, 6, 8, 9, 10])
def test_smallcin_rows_are_the_packs_non_zero_rows(rng, cin):
    """K2w's float32 walk (``smallcin_rows``: 3 * Cin rounded up to 8, at
    most kg) covers every non-zero row of the pack; the plain product on
    the rows past it set to NaN gives the clean pack's bits."""
    rows, kg = pool.smallcin_rows(cin), pool.smallcin_kg(cin)
    assert 3 * cin <= rows <= kg and rows % 8 == 0 and rows - 3 * cin < 8
    x, w, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, 2, cin, 8, 20, 6))
    p0, wk = pool.smallcin_pack(x, w)
    assert not p0[:, :, 3 * cin:].any() and not wk.view(6, 3, kg)[..., 3 * cin:].any()
    poisoned = p0.clone()
    poisoned[:, :, rows:] = float("nan")
    want = pool.smallcin_wide_product(p0, wk, scale, bias, 2, 20, cin)
    assert torch.equal(pool.smallcin_wide_product(poisoned, wk, scale, bias, 2, 20, cin), want)


@pytest.mark.parametrize("cin", [4, 8, 12])
def test_im2col_plain_matches_pallas(rng, cin):
    x, w, scale, bias = _inputs(rng, 2, cin, 8, 32, 12)
    got = pool.conv2d_im2col_bn_relu_fpool(*map(torch.from_numpy, (x, w, scale, bias)), 4)
    want = jpool.conv2d_im2col_bn_relu_fpool(*_jax_args(x, w, scale, bias), pool_f=4,
                                             block_t=16, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("cin", [8, 12, 16])
def test_windows_plain_matches_pallas(rng, cin):
    x, w, scale, bias = _inputs(rng, 2, cin, 8, 32, 12)
    got = pool.conv2d_windows_bn_relu_fpool(*map(torch.from_numpy, (x, w, scale, bias)), 2)
    want = jpool.conv2d_bn_relu_fpool(*_jax_args(x, w, scale, bias), pool_f=2, block_t=16,
                                      interpret=True)
    _close(got, want)


def _nan_jax(name, x, w, scale, bias, pf):
    """The JAX package's Pallas function of each serving-stage kernel in
    interpret mode on x (B, Cin, F, T); its output as (B, Cout, F / pf, T)."""
    b, cin, f, t = x.shape
    if name == "k3":   # CT layout (B, F, C, T_pad), columns >= t zero by contract
        h_ct = np.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 0), (0, 24)))
        out = jpool.conv2d_widecin_ct_bn_relu_fpool(
            jnp.asarray(h_ct), t, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
            pool_f=pf, interpret=True)
        return np.asarray(out)[..., :t].transpose(0, 2, 1, 3)
    fn, kw = {"k2": (jpool.conv2d_smallcin_thin_bn_relu_fpool, {}),
              "k10b": (jpool.conv2d_bn_relu_fpool, {"block_t": 16}),
              "k2w": (jpool.conv2d_smallcin_bn_relu_fpool, {}),
              "k10a": (jpool.conv2d_im2col_bn_relu_fpool, {"block_t": 16})}[name]
    out = fn(*_jax_args(x, w, scale, bias), pool_f=pf, interpret=True, **kw)
    return np.asarray(out).transpose(0, 3, 1, 2)


NAN_CASES = {  # kernel -> (the port's wrapper, whose CPU path is its plain version; Cin)
    "k2": (pool.conv2d_smallcin_bn_relu_fpool, 8),
    "k3": (pool.conv2d_widecin_bn_relu_fpool, 16),
    "k10b": (pool.conv2d_windows_bn_relu_fpool, 12),
    "k2w": (pool.conv2d_smallcin_wide_bn_relu_fpool, 8),
    "k10a": (pool.conv2d_im2col_bn_relu_fpool, 12),
}


@pytest.mark.parametrize("name", list(NAN_CASES))
def test_plain_versions_keep_nans_as_jax(rng, name):
    """A NaN in x stays NaN through ReLU and the pool in the port's plain
    versions (torch.relu, max_pool2d) exactly where the JAX package's
    Pallas function keeps it (jnp.maximum, jnp.max); the finite outputs
    within 1e-5 x max. The kernels are held to these plain versions, NaN
    for NaN, on the card (``test_conv_pool_keeps_nans``)."""
    fn, cin = NAN_CASES[name]
    x, w, scale, bias = _inputs(rng, 2, cin, 8, 32, 12)
    x[0, 1, 3, 10] = np.nan
    x[1, cin - 1, 7, 31] = np.nan
    got = fn(*map(torch.from_numpy, (x, w, scale, bias)), 2).numpy()
    want = _nan_jax(name, x, w, scale, bias, 2)
    nan = np.isnan(want)
    assert nan[0].any() and nan[1].any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(np.where(nan, 0, got), np.where(nan, 0, want), rtol=0,
                               atol=F32_TOL * np.abs(want[~nan]).max())


def test_im2col_patches_tap_order(rng):
    """patches[b, f, t, (dy * 3 + dx) * Cin + c] = xpad[b, c, f + dy, t + dx],
    the JAX packer's order, so patches @ w.reshape(9 * Cin, Cout) is the conv."""
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    got = pool.im2col_patches(torch.from_numpy(x)).numpy()
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    assert got.shape == (2, 5, 7, 27)
    for dy in range(3):
        for dx in range(3):
            tap = (dy * 3 + dx) * 3
            want = xp[:, :, dy:dy + 5, dx:dx + 7].transpose(0, 2, 3, 1)
            assert np.array_equal(got[..., tap:tap + 3], want)


@pytest.mark.parametrize("cin,cout", [(3, 80), (12, 64), (20, 200), (8, 70)])
def test_im2col_operands_pad_k_and_cout_for_bf16(rng, cin, cout):
    """The bfloat16 kernel's operands: K padded to a multiple of 8 with zero
    patch columns and zero weight rows, weight rows padded to a multiple of
    8 channels with zeros; the product's first Cout columns are the
    unpadded product exactly (float64 sums of bf16 values). float32 takes
    the patches and weights as they are."""
    x, w, _, _ = _inputs(rng, 2, cin, 6, 9, cout)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    patches, wk = pool.im2col_operands(xb, wb)
    k, kp = 9 * cin, -(-9 * cin // 8) * 8
    assert patches.shape == (2, 6, 9, kp) and wk.shape == (kp, -(-cout // 8) * 8)
    assert patches.is_contiguous() and wk.is_contiguous()
    assert torch.equal(patches[..., :k], pool.im2col_patches(xb))
    assert not patches[..., k:].any() and not wk[k:].any() and not wk[:, cout:].any()
    assert torch.equal(wk[:k, :cout], wb.reshape(k, cout))
    got = patches.double() @ wk.double()
    want = pool.im2col_patches(xb).double() @ wb.reshape(k, cout).double()
    assert torch.equal(got[..., :cout], want)
    p32, w32 = pool.im2col_operands(torch.from_numpy(x), torch.from_numpy(w))
    assert p32.shape[-1] == k and torch.equal(w32, torch.from_numpy(w).reshape(k, cout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,cin,cout", [("wide", 5, 7), ("wide", 10, 12),
                                           ("im2col", 3, 7), ("im2col", 12, 16)])
def test_products_on_built_operands_are_the_wrappers(rng, dtype, name, cin, cout):
    """The wrappers are the operand build, then the product on its
    operands: ``smallcin_wide_product`` on ``smallcin_pack``'s, bit for bit,
    and ``im2col_product`` on ``im2col_operands``' (in bfloat16 K and Cout
    padded with zeros, so the float32 sums may round apart: 1e-5 x max, or
    1e-2 x max where the output is bfloat16, under one bf16 ulp)."""
    x, w, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, 2, cin, 8, 33, cout))
    x, w = x.to(dtype), w.to(dtype)
    if name == "wide":
        got = pool.smallcin_wide_product(*pool.smallcin_pack(x, w), scale, bias, 4, 33, cin)
        want = pool.conv2d_smallcin_wide_bn_relu_fpool(x, w, scale, bias, 4)
        assert torch.equal(got, want)
        return
    got = pool.im2col_product(*pool.im2col_operands(x, w), scale, bias, 4)
    want = pool.conv2d_im2col_bn_relu_fpool(x, w, scale, bias, 4)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (2, cout, 2, 33)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * want.float().abs().max().item())


@pytest.mark.parametrize("name,cin,t,pf", [
    ("wide", 4, 40, 2), ("wide", 10, 130, 4),
    ("im2col", 3, 40, 2), ("im2col", 12, 33, 8),
    ("windows", 5, 40, 4), ("windows", 20, 129, 2),
])
def test_plain_versions_agree_in_float64(rng, name, cin, t, pf):
    """Each plain version against the plain conv composition, float64: the
    same function, so to rounding (1e-12 relative)."""
    fn = {"wide": pool.conv2d_smallcin_wide_bn_relu_fpool,
          "im2col": pool.conv2d_im2col_bn_relu_fpool,
          "windows": pool.conv2d_windows_bn_relu_fpool}[name]
    args = [torch.from_numpy(a) for a in _inputs(rng, 2, cin, 16, t, 9, np.float64)]
    got = fn(*args, pf)
    want = pool.conv2d_bn_relu_fpool_plain(*args, pf)
    assert got.dtype == torch.float64 and got.shape == want.shape == (2, 9, 16 // pf, t)
    torch.testing.assert_close(got, want, rtol=0, atol=F64_TOL * want.abs().max().item())


ROUTES = {  # Cin -> (kernel under 'thin', kernel under 'wide')
    1: ("conv3x3_smallcin", "conv3x3_smallcin_wide"),
    4: ("conv3x3_smallcin", "conv3x3_smallcin_wide"),
    8: ("conv3x3_smallcin", "conv3x3_smallcin_wide"),
    9: ("conv3x3_smallcin_wide", "conv3x3_smallcin_wide"),
    10: ("conv3x3_smallcin_wide", "conv3x3_smallcin_wide"),
    12: ("conv3x3_windows", "conv3x3_windows"),
    16: ("conv3x3_widecin", "conv3x3_widecin"),
    20: ("conv3x3_windows", "conv3x3_windows"),
    192: ("conv3x3_widecin", "conv3x3_widecin"),
}


@pytest.mark.parametrize("impl", ["thin", "wide"])
@pytest.mark.parametrize("cin", sorted(ROUTES))
def test_frontend_stage_kernel(cin, impl):
    assert pool.frontend_stage_kernel(cin, impl) == ROUTES[cin][impl == "wide"]


@pytest.mark.parametrize("impl,cin", [("wide", 8), ("thin", 10), ("thin", 12)])
def test_dispatcher_takes_the_routed_plain_version(rng, impl, cin):
    """On CPU tensors the dispatcher runs the routed kernel's plain version:
    the wide pack's product for K2w, the conv composition for K10b."""
    args = [torch.from_numpy(a) for a in _inputs(rng, 1, cin, 8, 20, 6)]
    got = pool.conv2d_bn_relu_fpool(*args, 4, smallcin_impl=impl)
    want = (pool.conv2d_smallcin_wide_bn_relu_fpool_plain(*args, 4) if 3 * cin <= 32
            else pool.conv2d_bn_relu_fpool_plain(*args, 4))
    assert torch.equal(got, want)


@pytest.mark.parametrize("call", ["wide_cin", "wide_w", "wide_pool", "im2col_w",
                                  "im2col_scale", "windows_pool", "windows_x",
                                  "impl", "route_impl", "route_cin", "wide_product_wk",
                                  "wide_product_cin",
                                  "im2col_product_wk", "im2col_product_k"])
def test_wrappers_reject_bad_inputs(call):
    x = torch.zeros(2, 11, 16, 10)
    w = torch.zeros(3, 3, 11, 4)
    s = torch.ones(4)
    cases = {
        "wide_cin": lambda: pool.conv2d_smallcin_wide_bn_relu_fpool(x, w, s, s, 2),  # 3 * 11 > 32
        "wide_w": lambda: pool.conv2d_smallcin_wide_bn_relu_fpool(x[:, :8], w, s, s, 2),
        "wide_pool": lambda: pool.conv2d_smallcin_wide_bn_relu_fpool(
            x[:, :8], w[:, :, :8], s, s, 3),
        "im2col_w": lambda: pool.conv2d_im2col_bn_relu_fpool(x, w[:2], s, s, 2),
        "im2col_scale": lambda: pool.conv2d_im2col_bn_relu_fpool(x, w, s[:3], s, 2),
        "windows_pool": lambda: pool.conv2d_windows_bn_relu_fpool(x, w, s, s, 5),
        "windows_x": lambda: pool.conv2d_windows_bn_relu_fpool(x[0], w, s, s, 2),
        "impl": lambda: pool.conv2d_bn_relu_fpool(x, w, s, s, 2, smallcin_impl="auto"),
        "route_impl": lambda: pool.frontend_stage_kernel(8, "pallas"),
        "route_cin": lambda: pool.frontend_stage_kernel(0),
        # the products take only their operand builds' shapes
        "wide_product_wk": lambda: pool.smallcin_wide_product(
            torch.zeros(2, 18, 32, 128), torch.zeros(4, 48), s, s, 2, 10, 8),
        "wide_product_cin": lambda: pool.smallcin_wide_product(
            torch.zeros(2, 18, 32, 128), torch.zeros(4, 96), s, s, 2, 10, 5),
        "im2col_product_wk": lambda: pool.im2col_product(
            torch.zeros(2, 16, 10, 99), torch.zeros(99, 8), s, s, 2),
        "im2col_product_k": lambda: pool.im2col_product(
            torch.zeros(2, 16, 10, 99, dtype=torch.bfloat16),
            torch.zeros(99, 8, dtype=torch.bfloat16), s, s, 2),
    }
    with pytest.raises((ValueError, TypeError)):
        cases[call]()
