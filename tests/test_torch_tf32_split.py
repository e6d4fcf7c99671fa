"""The split-TF32 arithmetic of the float32 tensor-core kernels (K4's
forward, K6's backward passes, K7 and K9's dW, ``csrc/mma.cuh``), through
its plain version ``ops/kernels/tf32.py``, on the CPU: the rounding is
``cvt.rna.tf32.f32``'s (held to a float64 reference written independently
of the bit trick), a non-finite operand never gives a finite product, hi +
lo recovers x within 2^-22 |x|, the split is odd in the sign, the
three-term product summed over a K9 stage-2 depth stays as close to float64
as the float32 plain version, and so do K5's dW tile
(``conv_dw_tf32_plain``, at the flagship's stage-1 depth), K2w's and
K10a's products (``smallcin_wide_product_tf32_plain``,
``im2col_product_tf32_plain``, at stage-1 and stage-2 depth), the conv
block tile of K3, K10b and K9's F1 / F2 (``conv_rows_tf32_plain``,
``conv_pool_tf32_plain``, at K3's stage-2 depth and K10b's Cin 12), K9's dh
on the same tile (``ct_dx_tf32_plain``, at the stage-2 depth and a ragged
Cout chunk) and K7's,
K4's and K6's whole arithmetic (``hamilton_matmul_tf32_plain``,
``flash_attention_tf32_plain``, ``flash_attention_bwd_tf32_plain``; K4
and K6 also past head dim 128, at the wide kernels' padded D), which also
agree with the JAX package's functions on the CPU. The tensor cores' own
accumulation is the card's (``tests/test_torch_cuda.py``). The tests
that call the JAX package import it themselves: the rest of the module
also runs where JAX is not installed (``ab_variants --tests``).
"""

import numpy as np
import pytest
import torch

from seld_tpu_torch.ops.kernels import conv2d_pool as pool
from seld_tpu_torch.ops.kernels.attention import flash_attention_bwd_plain, flash_attention_plain
from seld_tpu_torch.ops.kernels.conv2d_train import dw_plain
from seld_tpu_torch.ops.kernels.qmatmul import hamilton_matmul_plain
from seld_tpu_torch.ops.kernels.tf32 import (
    conv_dw_tf32_plain, flash_attention_bwd_tf32_plain, flash_attention_tf32_plain,
    conv_pool_tf32_plain, conv_rows_tf32_plain, ct_dx_tf32_plain, hamilton_matmul_tf32_plain,
    im2col_product_tf32_plain, smallcin_wide_product_tf32_plain, tf32_add_half_and_mask,
    tf32_round_plain, tf32_split_plain,
)

LOW_BITS = 0x1FFF


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, halves away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) / 2.0**11
    return np.ldexp(r, e)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_rounding_is_cvt_rna(scale):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20_000) * scale).astype(np.float32))
    got = tf32_round_plain(x)
    assert not (_bits(got) & LOW_BITS).any()
    np.testing.assert_array_equal(got.numpy().astype(np.float64), _tf32_reference(x.numpy()))


def test_ties_round_away_from_zero():
    # a fraction whose dropped 13 bits are exactly half a TF32 ulp (0x1000),
    # with the kept bits even and odd, at both signs
    bits = np.array([0x3F801000, 0x3F803000, 0xBF801000, 0xBF803000, 0x7F7FF000],
                    dtype=np.uint32)
    got = _bits(tf32_round_plain(torch.from_numpy(bits.view(np.float32))))
    np.testing.assert_array_equal(got, [0x3F802000, 0x3F804000, 0xBF802000, 0xBF804000,
                                        0x7F800000])
    # just under half rounds down, in magnitude
    under = np.array([0x3F800FFF, 0xBF800FFF], dtype=np.uint32).view(np.float32)
    np.testing.assert_array_equal(_bits(tf32_round_plain(torch.from_numpy(under))),
                                  [0x3F800000, 0xBF800000])


# NaNs: float('nan'), the card's own 0x7fffffff and its negative, payloads
# only in the low 13 bits, and fractions whose top ten bits are all ones
NANS = np.array([0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0xFF801FFF, 0x7FFFF000,
                 0x7FFFE001], dtype=np.uint32)


def test_non_finite_values_pass_through():
    """hi (cvt.rna) keeps every NaN a NaN and an infinity the infinity; the
    add-and-mask form that lo takes would turn 0x7fffffff into a zero."""
    nans = torch.from_numpy(NANS.view(np.float32))
    assert bool(torch.isnan(tf32_round_plain(nans)).all())
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(tf32_round_plain(inf), inf)
    np.testing.assert_array_equal(_bits(tf32_round_plain(torch.tensor([0.0, -0.0]))),
                                  [0, 0x80000000])
    assert _bits(tf32_add_half_and_mask(nans[1:3])).tolist() == [0x80000000, 0]
    hi, lo = tf32_split_plain(torch.cat([nans, inf]))
    assert not bool(torch.isfinite(hi).any())
    assert bool((torch.isnan(lo) | (lo == 0)).all())


def test_a_non_finite_operand_gives_a_non_finite_product():
    """The three-term product of split operands, each term in float64: NaN
    where either operand is a NaN, and never finite where one is infinite."""
    a = torch.cat([torch.from_numpy(NANS.view(np.float32)), torch.tensor([float("inf")])])
    b = torch.tensor([1.5, -3.0e-7, 2.0 ** 20, 1.0 + 2.0 ** -20, 0.7, -1e30, 4.0, 3.0])
    (ah, al), (bh, bl) = tf32_split_plain(a), tf32_split_plain(b)
    prod = sum(x.double() * y.double() for x, y in ((al, bh), (ah, bl), (ah, bh)))
    assert bool(torch.isnan(prod[:-1]).all()) and not bool(torch.isfinite(prod[-1]))
    (bh, bl), (ah, al) = (ah, al), tf32_split_plain(b)   # the NaN as the B operand
    prod = sum(x.double() * y.double() for x, y in ((al, bh), (ah, bl), (ah, bh)))
    assert bool(torch.isnan(prod[:-1]).all())


def test_lo_rounding_is_cvt_rna_on_finite_values():
    """On every finite float32 (random bit patterns, all exponents) the
    kernels' add-and-mask rounding of lo equals cvt.rna's."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32))
    x = x[torch.isfinite(x)]
    np.testing.assert_array_equal(_bits(tf32_add_half_and_mask(x)), _bits(tf32_round_plain(x)))


@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e20])
def test_split_recovers_x(scale):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(50_000) * scale).astype(np.float32))
    hi, lo = tf32_split_plain(x)
    assert not (_bits(hi) & LOW_BITS).any() and not (_bits(lo) & LOW_BITS).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_three_term_dw_at_stage_2_depth(seed):
    """dW over K9's stage-2 depth (B * F * T = 2 * 32 * 4800 = 307,200
    frames), narrow channels: the split product summed in float64 stays
    within 4x the float32 plain version's distance from float64."""
    rng = np.random.default_rng(seed)
    b, c, f, t, cout = 2, 8, 32, 4800, 8
    h = torch.from_numpy(rng.standard_normal((b, c, f, t)).astype(np.float32))
    gz = torch.from_numpy((rng.standard_normal((b, cout, f, t)) * 1e-2).astype(np.float32))
    exact = dw_plain(h.double(), gz.double())
    (hh, hl), (gh, gl) = tf32_split_plain(h), tf32_split_plain(gz)
    split = sum(dw_plain(x.double(), y.double()) for x, y in ((hl, gh), (hh, gl), (hh, gh)))
    plain = dw_plain(h, gz)
    d_split = (split - exact).abs().max().item()
    d_plain = (plain.double() - exact).abs().max().item()
    assert d_split <= 4 * d_plain, (d_split, d_plain)


@pytest.mark.parametrize("b,c,f,t,cout", [(2, 8, 256, 4800, 8), (1, 5, 4, 1000, 12)],
                         ids=["stage-1-depth", "frame-shares"])
def test_k5_dw_tile_at_stage_1_depth(b, c, f, t, cout):
    """K5's float32 dW tile as the kernel sums it (``conv_dw_tf32_plain``:
    64-frame steps summed from zero, 512 depth shares each adding its steps
    in float32, the shares in float64) over the flagship's stage-1 depth (B
    * F * T = 2 * 256 * 4800 = 2,457,600 frames, one (b, f) row a share) at
    Cin 8, narrow Cout, and at Cin 5 over 4 rows, whose frames split into
    shares of 64-frame steps: within 4x the float32 plain version's max|d|
    from float64."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((b, c, f, t)).astype(np.float32))
    gz = torch.from_numpy((rng.standard_normal((b, cout, f, t)) * 1e-2).astype(np.float32))
    exact = dw_plain(x.double(), gz.double())
    d_split, d_plain = _dist(conv_dw_tf32_plain(x, gz), exact), _dist(dw_plain(x, gz), exact)
    assert d_split <= 4 * d_plain, (d_split, d_plain)


def test_split_is_odd_in_the_sign():
    """split(-x) = -split(x) on finite x, all exponents: hi bit for bit, and
    lo bit for bit wherever it is not zero; where lo is zero, it is zero at
    both signs, but its own sign need not flip (x - hi = +0 for a TF32 value
    x of either sign), and a zero of either sign adds nothing to a sum. So
    K7 may negate a component before or after splitting it."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32))
    x = torch.cat([x[torch.isfinite(x)], tf32_round_plain(x[torch.isfinite(x)][:1000]),
                   torch.tensor([0.0, -0.0])])
    (hi, lo), (hi_n, lo_n) = tf32_split_plain(x), tf32_split_plain(-x)
    np.testing.assert_array_equal(_bits(hi_n), _bits(-hi))
    nz = lo != 0
    assert int((~nz).sum()) >= 1000
    np.testing.assert_array_equal(_bits(lo_n[nz]), _bits(-lo[nz]))
    assert bool((lo_n[~nz] == 0).all())


def _dist(a, exact):
    return (a.double() - exact).abs().max().item()


# (name, n, cin_c, cout_c, linear_table, the JAX op's name and keywords): the
# flagship's depth of 384 in each orientation
K7_OPS = [
    ("q", 4, 96, 24, False, "pallas_q_linear", {}),
    ("dq_linear", 8, 48, 48, True, "pallas_dq_linear", {}),
    ("dq_conv", 8, 48, 48, False, "pallas_dq_linear", {"conv_table": True}),
]


@pytest.mark.parametrize("name,n,cin_c,cout_c,table,jax_op,kw", K7_OPS,
                         ids=[o[0] for o in K7_OPS])
def test_k7_split_arithmetic_at_the_flagship_depth(name, n, cin_c, cout_c, table, jax_op, kw):
    """K7's float32 arithmetic at K = 384: within 4x the float32 plain
    version's max|d| from float64, and within 1e-5 x max of the Pallas op in
    interpret mode (the JAX package's bound for its kernel)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from seld_tpu.ops.pallas import qmatmul as jqm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((96, n * cin_c)).astype(np.float32)
    comps = (rng.standard_normal((n, cin_c, cout_c)) / cin_c ** 0.5).astype(np.float32)
    bias = rng.standard_normal(n * cout_c).astype(np.float32)
    xt, ct, bt = map(torch.from_numpy, (x, comps, bias))
    got = hamilton_matmul_tf32_plain(xt, ct, bt, n, table)
    exact = hamilton_matmul_plain(xt.double(), ct.double(), bt.double(), n, table)
    d_split, d_plain = _dist(got, exact), _dist(hamilton_matmul_plain(xt, ct, bt, n, table), exact)
    assert d_split <= 4 * d_plain, (d_split, d_plain)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(jqm, jax_op)(jnp.asarray(x), jnp.asarray(comps),
                                               jnp.asarray(bias), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# every instantiated head dim, and past 128 the wide kernels' plan: 136 (padded
# to 160), 160 and 256, one column group each
ATTN_DIMS = [16, 32, 48, 64, 128, 136, 160, 256]


@pytest.mark.parametrize("d", ATTN_DIMS)
@pytest.mark.parametrize("t", [65, 200])
def test_k4_split_arithmetic(t, d):
    """K4's float32 arithmetic (64-key tiles, a ragged last one; past head
    dim 128 at the wide kernels' padded D, S over all of it): out and lse
    within 4x the float32 plain version's max|d| from float64; out within
    2e-4 x max of the JAX ``flash_attention`` on the CPU (at these T its
    chunked XLA path) and lse of the float64 logsumexp."""
    import jax.numpy as jnp

    from seld_tpu.ops.pallas.attention import flash_attention as jflash

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, t, 3, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_tf32_plain(qt, kt, vt, scale)
    exact = flash_attention_plain(qt.double(), kt.double(), vt.double(), scale)
    plain = flash_attention_plain(qt, kt, vt, scale)
    for got, p, e in zip((out, lse), plain, exact):
        assert got.shape == e.shape
        assert _dist(got, e) <= 4 * _dist(p, e), (_dist(got, e), _dist(p, e))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                             interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())
    lse_64 = exact[1].numpy()
    np.testing.assert_allclose(lse.numpy(), lse_64, rtol=0, atol=2e-4 * np.abs(lse_64).max())


@pytest.mark.parametrize("d", ATTN_DIMS)
@pytest.mark.parametrize("t", [65, 200])
def test_k6_split_arithmetic(t, d):
    """K6's float32 arithmetic (``flash_attention_bwd_tf32_plain``: S and dP
    over the padded D, dQ, dK and dV over the keys and queries, every
    product in k8 steps of three, summed in two levels) from the float32
    plain forward's out and lse: dq, dk and dv each within 4x the float32
    plain backward's max|d| from float64, and within 2e-4 x max of the
    gradients of the JAX ``flash_attention`` (``jax.vjp``, interpret mode)."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.ops.pallas.attention import flash_attention as jflash

    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((2, t, 3, d)).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_plain(qt, kt, vt, scale)
    got = flash_attention_bwd_tf32_plain(qt, kt, vt, out, gt, lse, scale)
    exact = flash_attention_bwd_plain(*(a.double() for a in (qt, kt, vt, out, gt, lse)), scale)
    plain = flash_attention_bwd_plain(qt, kt, vt, out, gt, lse, scale)
    for a, p, e in zip(got, plain, exact):
        assert a.shape == e.shape
        assert _dist(a, e) <= 4 * _dist(p, e), (_dist(a, e), _dist(p, e))
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, scale, interpret=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for a, want in zip(got, vjp(jnp.asarray(g))):
        want = np.asarray(want)
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())


def _frontend_inputs(seed, b, cin, f, t, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, f, t)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(cout)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(cout)).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, w, scale, bias)))


def _frontend_tf32(name, x, w, scale, bias, pf, rows=None):
    """K2w's (over ``rows`` rows of each kg group, by default its walk) or
    K10a's float32 kernel arithmetic on x."""
    if name == "k2w":
        cin = x.shape[1]
        return smallcin_wide_product_tf32_plain(*pool.smallcin_pack(x, w), scale, bias, pf,
                                                x.shape[3], rows or pool.smallcin_rows(cin))
    return im2col_product_tf32_plain(pool.im2col_patches(x), w.reshape(-1, w.shape[3]), scale,
                                     bias, pf)


# (kernel, b, cin, f, t, cout, pf): stage-1 depth (K2w at Cin 8: K 72 of the
# pack's 96; K10a: K 72) and stage-2 depth (K10a at Cin 192: K 1728), narrow
FRONTEND_DEPTHS = [("k2w", 2, 8, 16, 300, 12, 8), ("k10a", 2, 8, 16, 300, 12, 8),
                   ("k10a", 1, 192, 4, 64, 12, 2)]


@pytest.mark.parametrize("name,b,cin,f,t,cout,pf", FRONTEND_DEPTHS,
                         ids=["k2w-stage-1", "k10a-stage-1", "k10a-stage-2"])
def test_k2w_k10a_split_arithmetic(name, b, cin, f, t, cout, pf):
    """K2w's and K10a's float32 arithmetic (split operands, each k8 step's
    three products summed once, added in K order to a float32
    accumulator, then the epilogue) within 4x the float32 plain version's
    max|d| from float64 at stage-1 and stage-2 depth; K2w walking only the
    pack's first 3 Cin rounded up to 8 rows of each group gives the same
    bits as walking all of them (the skipped steps add zeros)."""
    x, w, scale, bias = _frontend_inputs(3, b, cin, f, t, cout)
    plain_fn = {"k2w": pool.conv2d_smallcin_wide_bn_relu_fpool,
                "k10a": pool.conv2d_im2col_bn_relu_fpool}[name]
    got = _frontend_tf32(name, x, w, scale, bias, pf)
    exact = plain_fn(x.double(), w.double(), scale.double(), bias.double(), pf)
    d_split, d_plain = _dist(got, exact), _dist(plain_fn(x, w, scale, bias, pf), exact)
    assert d_split <= 4 * d_plain, (d_split, d_plain)
    if name == "k2w":
        assert pool.smallcin_rows(cin) < pool.smallcin_kg(cin)
        walk_all = _frontend_tf32(name, x, w, scale, bias, pf, rows=pool.smallcin_kg(cin))
        assert torch.equal(walk_all, got)


@pytest.mark.parametrize("name,cin,pf", [("k2w", 5, 4), ("k2w", 10, 2), ("k10a", 3, 4),
                                         ("k10a", 12, 2)])
def test_k2w_k10a_split_arithmetic_matches_jax(name, cin, pf):
    """K2w's and K10a's float32 kernel arithmetic against the JAX package's
    ``conv2d_smallcin_bn_relu_fpool`` / ``conv2d_im2col_bn_relu_fpool`` in
    interpret mode on the same inputs, within 1e-5 x max (the conv-pool
    tests' bound)."""
    import jax.numpy as jnp

    from seld_tpu.ops.pallas import conv2d_pool as jpool

    x, w, scale, bias = _frontend_inputs(4, 2, cin, 8, 32, 12)
    got = _frontend_tf32(name, x, w, scale, bias, pf)
    args = (jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), *(jnp.asarray(a.numpy())
                                                          for a in (w, scale, bias)))
    if name == "k2w":
        want = jpool.conv2d_smallcin_bn_relu_fpool(*args, pool_f=pf, interpret=True)
    else:
        want = jpool.conv2d_im2col_bn_relu_fpool(*args, pool_f=pf, block_t=16, interpret=True)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# (b, cin, f, t, cout, pf): K3 at the flagship's stage-2 depth (Cin 192: 24
# chunks of 8 channels), K10b at Cin 12 (a ragged second chunk) and Cin 8 (one
# chunk, stage 1); the float smallcin tile's stage 1 (K2, K5's F1 / F2 / g_z
# rows, the same K walk) at Cin 5 and 8 (one zero-filled chunk) and 10 (a
# second chunk of 2 channels); T ragged against the tiles' 64 and 128 frames,
# Cout against their 64 channels, several blocks of rows
CONV_TILE_DEPTHS = [(1, 192, 8, 70, 72, 4), (2, 12, 16, 130, 20, 8), (2, 8, 16, 70, 12, 8),
                    (2, 5, 16, 130, 20, 4), (1, 8, 32, 70, 72, 16), (2, 10, 16, 70, 12, 8)]


@pytest.mark.parametrize("b,cin,f,t,cout,pf", CONV_TILE_DEPTHS,
                         ids=["k3-stage-2", "k10b-cin-12", "k10b-cin-8", "k2-cin-5", "k2-cin-8",
                              "k5-cin-10"])
def test_conv_tile_split_arithmetic(b, cin, f, t, cout, pf):
    """The float conv block tile's arithmetic (split operands, each k8 step
    of one tap x 8 channels summed once, added to a float32 accumulator in
    the K walk: chunks, then taps) within 4x the float32 plain version's
    max|d| from float64 (the card's gate), on the pooled output (K3, K10b,
    K9's F2) and on the conv rows (K9's F1 ``pre``); F2's pooled output is
    the epilogue of F1's rows, bit for bit."""
    x, w, scale, bias = _frontend_inputs(5, b, cin, f, t, cout)
    got = conv_pool_tf32_plain(x, w, scale, bias, pf)
    exact = pool.conv2d_bn_relu_fpool_plain(x.double(), w.double(), scale.double(),
                                            bias.double(), pf)
    plain = pool.conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    assert _dist(got, exact) <= 4 * _dist(plain, exact), (_dist(got, exact), _dist(plain, exact))
    rows = conv_rows_tf32_plain(x, w)
    conv = lambda a, b_: torch.nn.functional.conv2d(a, b_.permute(3, 2, 0, 1), padding=1)
    exact_rows = conv(x.double(), w.double())
    assert _dist(rows, exact_rows) <= 4 * _dist(conv(x, w), exact_rows)
    assert torch.equal(pool._epilogue(rows, scale, bias, pf, torch.float32), got)


@pytest.mark.parametrize("name,cin,pf", [("k3", 16, 2), ("k3", 24, 4), ("k10b", 12, 2),
                                         ("k10b", 8, 4), ("k9", 16, 2), ("k9", 24, 4),
                                         ("k2", 5, 4), ("k2", 8, 2), ("k5", 5, 4), ("k5", 8, 2),
                                         ("k5", 10, 4)])
def test_conv_tile_split_arithmetic_matches_jax(name, cin, pf):
    """The float conv tiles' arithmetic (the block tile's and, on the same
    K walk, the float smallcin tile's) against the JAX package's
    ``conv2d_widecin_ct_bn_relu_fpool`` (K3), ``conv2d_bn_relu_fpool``
    (K10b), ``conv2d_smallcin_thin_bn_relu_fpool`` (K2),
    ``conv2d_widecin_ct_bn_relu_fpool_train``'s forward (K9) and
    ``conv2d_smallcin_bn_relu_fpool_train``'s (K5; thin pack at Cin <= 8,
    wide at 10; HIGHEST precision): out, mean and var from F1's rows, the
    batch statistics in float64 as the kernels' fixed-order reduction takes
    them, in interpret mode on the same inputs: K3, K10b and K2 within 1e-5
    x max (the conv-pool tests' bound), K9 and K5 within 2e-4 x max (the
    bound ``tests/test_torch_ct_train.py`` and
    ``tests/test_torch_train_kernels.py`` hold the ops' forwards to)."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.ops.pallas.conv2d_ct_train import conv2d_widecin_ct_bn_relu_fpool_train
    from seld_tpu.ops.pallas.conv2d_train import conv2d_smallcin_bn_relu_fpool_train
    from tests.test_torch_conv_pool import _nan_jax

    b, f, t, cout = 2, 8, 40, 12
    x, w, scale, bias = _frontend_inputs(6, b, cin, f, t, cout)
    if name not in ("k9", "k5"):
        got = conv_pool_tf32_plain(x, w, scale, bias, pf)
        want = _nan_jax(name, *(a.numpy() for a in (x, w, scale, bias)), pf)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    gamma, beta, eps = scale, bias, 1e-5
    pre = conv_rows_tf32_plain(x, w).double()
    mean = pre.mean((0, 2, 3))
    var = torch.clamp((pre * pre).mean((0, 2, 3)) - mean * mean, min=0.0)
    sc = gamma.double() * torch.rsqrt(var + eps)
    out = conv_pool_tf32_plain(x, w, sc.float(), (beta.double() - mean * sc).float(), pf)
    params = [jnp.asarray(a.numpy()) for a in (w, gamma, beta)]
    if name == "k5":
        jout, jmean, jvar = conv2d_smallcin_bn_relu_fpool_train(
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), *params, pf, eps, True,
            jax.lax.Precision.HIGHEST, pack="thin" if cin <= 8 else "wide")
        want_out = np.asarray(jout).transpose(0, 3, 1, 2)
    else:
        h_ct = jnp.asarray(x.numpy().transpose(0, 2, 1, 3))
        jout, jmean, jvar = conv2d_widecin_ct_bn_relu_fpool_train(
            h_ct, t, *params, pf, eps, interpret=True)
        want_out = np.asarray(jout)[..., :t].transpose(0, 2, 1, 3)
    for g_, w_ in ((out, want_out), (mean, jmean), (var, jvar)):
        w_ = np.asarray(w_, np.float64)
        np.testing.assert_allclose(g_.double().numpy(), w_, rtol=0, atol=2e-4 * np.abs(w_).max())


# (b, cin, f, t, cout): dh's K = 9 x Cout, gz's channels in chunks of 8: K9's
# stage-2 depth (Cout 192: 24 chunks) and a ragged last chunk (Cout 100), Cin
# (dh's channels) against the tile's 64, T against its 64 frames
CT_DX_DEPTHS = [(1, 72, 8, 70, 192), (2, 12, 10, 130, 100)]


@pytest.mark.parametrize("b,cin,f,t,cout", CT_DX_DEPTHS, ids=["stage-2-depth", "cout-100"])
def test_ct_dx_split_arithmetic(b, cin, f, t, cout):
    """K9's float32 dh arithmetic (the block tile on the transposed weights:
    gz and w split, each k8 step of one tap x 8 gz channels summed once,
    added to a float32 accumulator in the K walk) within 4x the float32
    plain version's max|d| from float64 (the card's gate)."""
    from seld_tpu_torch.ops.kernels.conv2d_ct_train import ct_dx_plain

    rng = np.random.default_rng(7)
    gz = torch.from_numpy(rng.standard_normal((b, cout, f, t)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cout))
                         .astype(np.float32))
    got = ct_dx_tf32_plain(gz, w)
    exact = ct_dx_plain(gz.double(), w.double())
    d_split, d_plain = _dist(got, exact), _dist(ct_dx_plain(gz, w), exact)
    assert got.dtype == torch.float32 and got.shape == (b, cin, f, t)
    assert d_split <= 4 * d_plain, (d_split, d_plain)


@pytest.mark.parametrize("cin,cout,pf", [(16, 12, 2), (24, 20, 4)])
def test_ct_dx_split_arithmetic_matches_jax(cin, cout, pf):
    """K9's float32 dh arithmetic, fed the g_z of the port's backward (F1's
    rows on the split tile, the batch statistics in float64 as the kernels'
    fixed-order reduction takes them, B1 and g_z's plain versions), against
    the dh of the JAX package's ``conv2d_widecin_ct_bn_relu_fpool_train``
    through ``jax.vjp`` in interpret mode on the same inputs and cotangent,
    within 2e-4 x max (the bound ``tests/test_torch_ct_train.py`` holds the
    op's forward to); Cout 12 and 20 end in a ragged gz chunk."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.ops.pallas.conv2d_ct_train import conv2d_widecin_ct_bn_relu_fpool_train
    from seld_tpu_torch.ops.kernels.conv2d_ct_train import ct_gz_plain, ct_sel_stats_plain

    b, f, t, eps = 2, 8, 40, 1e-5
    x, w, gamma, beta = _frontend_inputs(8, b, cin, f, t, cout)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((b, cout, f // pf, t))
                         .astype(np.float32))
    pre = conv_rows_tf32_plain(x, w)
    mean = pre.double().mean((0, 2, 3))
    var = torch.clamp((pre.double() ** 2).mean((0, 2, 3)) - mean * mean, min=0.0)
    mean, inv = mean.float(), torch.rsqrt(var.float() + eps)
    scale = gamma * inv
    bias, zero, n = beta - mean * scale, torch.zeros(cout), b * f * t
    sel = ct_sel_stats_plain(pre, g, torch.stack([scale, bias, mean, inv, zero, zero]), pf)
    gz = ct_gz_plain(pre, g, torch.stack([scale, bias, mean, inv, sel[:cout] / n,
                                          sel[cout:] / n]), pf)
    got = ct_dx_tf32_plain(gz, w)

    def jfn(h_):
        return conv2d_widecin_ct_bn_relu_fpool_train(
            h_, t, *(jnp.asarray(a.numpy()) for a in (w, gamma, beta)), pf, eps, interpret=True)

    (out, mean_j, var_j), vjp = jax.vjp(jfn, jnp.asarray(x.numpy().transpose(0, 2, 1, 3)))
    cot = np.zeros(out.shape, np.float32)                          # (B, F', Cout, tpad)
    cot[..., :t] = g.numpy().transpose(0, 2, 1, 3)
    (dh,) = vjp((jnp.asarray(cot), jnp.zeros_like(mean_j), jnp.zeros_like(var_j)))
    want = np.asarray(dh, np.float64).transpose(0, 2, 1, 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("cin,pf", [(5, 4), (8, 8), (10, 4)])
def test_k5_routing_on_split_rows_matches_jax_vjp(cin, pf):
    """K5's float32 backward on the float smallcin tile's rows: F1's rows
    (``conv_rows_tf32_plain``, batch statistics in float64 as the kernels'
    fixed-order reduction takes them), F2 their pool, B1's sums from the
    pooled output, the g_z pass's routing of g to each window's first max
    of those rows (``route_rows_plain``) and the dW tile's arithmetic on its
    g_z (``conv_dw_tf32_plain``), then dgamma = inv (sum g_pre * acc - mean
    S_g) and dbeta = S_g; against ``jax.vjp`` of the JAX package's
    ``conv2d_smallcin_bn_relu_fpool_train`` in interpret mode (HIGHEST; thin
    pack at Cin <= 8, wide at 10) on the same inputs and cotangent, within
    2e-4 x max (the op's bound in ``tests/test_torch_train_kernels.py``)."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.ops.pallas.conv2d_train import conv2d_smallcin_bn_relu_fpool_train
    from seld_tpu_torch.ops.kernels import conv2d_train as k5

    b, f, t, cout, eps = 2, 16, 40, 12, 1e-5
    x, w, gamma, beta = _frontend_inputs(9, b, cin, f, t, cout)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (b, cout, f // pf, t)).astype(np.float32))
    rows = conv_rows_tf32_plain(x, w)
    pre = rows.double()
    n = b * f * t
    mean = pre.mean((0, 2, 3))
    var = torch.clamp((pre * pre).mean((0, 2, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = (gamma.double() * inv).float()
    bias = (beta.double() - mean * gamma.double() * inv).float()
    mean, inv = mean.float(), inv.float()
    out = conv_pool_tf32_plain(x, w, scale, bias, pf)
    p, q = inv / scale, (bias / scale + mean) * inv
    sel = k5.sel_stats_plain(out, g, p, q)
    a = inv * scale * sel[cout:] / n
    c = scale * sel[:cout] / n - mean * a
    gz, sg, sga = k5.route_rows_plain(rows, g, scale, bias, a, c, pf, torch.float32)
    dw = conv_dw_tf32_plain(x, gz)
    dgamma, dbeta = inv * (sga - mean * sg), sg

    def jfn(w_, g_, b_):
        return conv2d_smallcin_bn_relu_fpool_train(
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), w_, g_, b_, pf, eps, True,
            jax.lax.Precision.HIGHEST, pack="thin" if cin <= 8 else "wide")

    (jout, jmean, jvar), vjp = jax.vjp(jfn, *(jnp.asarray(v.numpy()) for v in (w, gamma, beta)))
    jdw, jdgamma, jdbeta = vjp((jnp.asarray(g.numpy().transpose(0, 2, 3, 1)),
                                jnp.zeros_like(jmean), jnp.zeros_like(jvar)))
    want_out = np.asarray(jout).transpose(0, 3, 1, 2)
    for got, want in ((out, want_out), (dw, jdw), (dgamma, jdgamma), (dbeta, jdbeta)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())
