"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips where torch has no CUDA device (this module
imports neither JAX nor the JAX package, so it also runs on a host without
them: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py``). Shapes span several blocks in every tiled
dimension and end in a ragged tail. Tolerances relative to max|ref|: float32
2e-4 (TF32 off, sums in another order), bfloat16 2e-2 (~2.5 ulps: the plain
versions round at other points).
"""

import pytest
import torch

import seld_tpu_torch
from seld_tpu_torch import _build
from seld_tpu_torch.models.attention import attend_full
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, reset_launch_counts, stream_handle,
)
from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
from seld_tpu_torch.ops.kernels import conv2d_pool as pool
from seld_tpu_torch.ops.kernels import conv2d_train as k5
from seld_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain,
    flash_attention_train,
)
from seld_tpu_torch.ops.kernels.conv2d_pool import (
    conv2d_bn_relu_fpool, conv2d_bn_relu_fpool_plain,
)
from seld_tpu_torch.ops.kernels.stft import stft_mag, stft_mag_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seld_tpu_torch.disable_tf32()
    reset_launch_counts()
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    tol = TOL[dtype] * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,nperseg,noverlap", [((3, 40_000), 512, 112),
                                                    ((2, 37_123), 480, 80)])
def test_stft_kernel(gen, dtype, shape, nperseg, noverlap):
    x = torch.randn(*shape, generator=gen, device="cuda")
    got = stft_mag(x, nperseg, noverlap, out_dtype=dtype)
    assert launch_counts["stft_mag"] == 1
    _close(got, stft_mag_plain(x, nperseg, noverlap, out_dtype=dtype), dtype)


# K1's float32 FFT kernel: (audio shape, nperseg, noverlap, audio dtype) at
# nperseg 64-2048, frames ragged against the block's 2048 / (nperseg / 2)
# frames, n % 4 != 0 and odd n (element-by-element gathers at the row's end),
# an odd hop (no pair loads), bf16 audio and 40 rows
STFT_FFT_CASES = [((3, 40_003), 256, 128, torch.float32), ((2, 117_123), 512, 112, torch.float32),
                  ((2, 100_700), 1024, 512, torch.float32),
                  ((2, 100_999), 2048, 1024, torch.float32),
                  ((3, 120_000), 512, 112, torch.bfloat16), ((40, 130_000), 512, 112, torch.float32),
                  ((2, 50_001), 512, 113, torch.float32), ((2, 30_001), 64, 16, torch.float32)]


@pytest.mark.parametrize("shape,nperseg,noverlap,xdt", STFT_FFT_CASES)
def test_stft_fft_kernel(gen, shape, nperseg, noverlap, xdt):
    """The FFT kernel against the plain version (float32, 2e-4 x max) and the
    plain DFT in float64 (1e-5 x max: the FFT's rounding grows as log N)."""
    x = torch.randn(*shape, generator=gen, device="cuda").to(xdt)
    got = stft_mag(x, nperseg, noverlap, out_dtype=torch.float32)
    assert launch_counts["stft_mag"] == 1 and launch_counts["stft_mag_fft"] == 1
    _close(got, stft_mag_plain(x, nperseg, noverlap, out_dtype=torch.float32), torch.float32)
    want = stft_mag_plain(x.double(), nperseg, noverlap, out_dtype=torch.float64)
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("nperseg,noverlap,fft", [(512, 112, 1), (480, 80, 0), (2048, 1024, 1),
                                                  (96, 48, 0)])
def test_stft_float32_route_on_the_card(gen, nperseg, noverlap, fft):
    """Power-of-two nperseg takes the FFT kernel, 480 and 96 the SIMT DFT."""
    x = torch.randn(2, 20_000, generator=gen, device="cuda")
    got = stft_mag(x, nperseg, noverlap, out_dtype=torch.float32)
    assert launch_counts["stft_mag"] == 1 and launch_counts["stft_mag_fft"] == fft
    _close(got, stft_mag_plain(x, nperseg, noverlap, out_dtype=torch.float32), torch.float32)


# K1's bf16-output kernel (the tensor-core GEMM): frames ragged against its
# 256-frame tiles, bins ragged against 64 (240, 244), nperseg 488 ragged against
# its 32-tap chunks, n % 4 != 0 (element-by-element gathers), bf16 audio, and 40
# rows, where each block walks two frame tiles
STFT_TC_CASES = [((3, 120_000), 512, 112, torch.float32), ((2, 117_123), 480, 80, torch.float32),
                 ((2, 100_000), 488, 88, torch.float32), ((3, 120_000), 512, 112, torch.bfloat16),
                 ((2, 100_003), 488, 88, torch.bfloat16), ((40, 130_000), 512, 112, torch.float32)]


@pytest.mark.parametrize("shape,nperseg,noverlap,xdt", STFT_TC_CASES)
def test_stft_tc_kernel_ragged(gen, shape, nperseg, noverlap, xdt):
    x = torch.randn(*shape, generator=gen, device="cuda").to(xdt)
    got = stft_mag(x, nperseg, noverlap, out_dtype=torch.bfloat16)
    assert launch_counts["stft_mag"] == 1
    want = stft_mag_plain(x, nperseg, noverlap, out_dtype=torch.bfloat16)
    _close(got, want, torch.bfloat16)


# K2's bf16 kernel (Cin <= 8 on the tensor cores): Cin 5 and 8, ragged Cout tiles
# (80, 200), ragged frame tiles (129, 300; 296 stages x by 16-byte loads), pf 2
# and 8, and pf 80, the largest its shared memory takes
SMALLCIN_TC_CASES = [(2, 5, 24, 300, 80, 8), (2, 8, 16, 296, 200, 2), (1, 8, 16, 129, 200, 8),
                     (2, 5, 8, 129, 80, 2), (1, 8, 32, 300, 200, 8), (2, 5, 16, 296, 80, 8),
                     (1, 3, 80, 300, 72, 80)]


@pytest.mark.parametrize("b,cin,f,t,cout,pf", SMALLCIN_TC_CASES)
def test_conv_smallcin_tc_kernel_ragged(gen, b, cin, f, t, cout, pf):
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).bfloat16()
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
    assert launch_counts["conv3x3_smallcin"] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), torch.bfloat16)


def test_tc_kernels_raise_past_their_shared_memory(gen):
    """K1's bf16 kernel holds its table tile in shared memory: past that
    limit a CUDA tensor raises, without a launch. K2's halo no longer
    limits its pool: a window one row past one staging runs in two chunks
    and matches the plain version."""
    with pytest.raises(ValueError):
        stft_mag(torch.zeros(1, 4000, device="cuda"), 736, 336, out_dtype=torch.bfloat16)
    assert all(v == 0 for v in launch_counts.values())
    top = pool.smallcin_max_pool_f(3, torch.bfloat16)
    x = torch.randn(1, 3, top + 1, 16, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(3, 3, 3, 8, generator=gen, device="cuda") / 27 ** 0.5).bfloat16()
    s = torch.ones(8, device="cuda")
    got = pool.conv2d_smallcin_bn_relu_fpool(x, w, s, s, top + 1)
    assert launch_counts["conv3x3_smallcin"] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, s, s, top + 1), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pf", [128, 256])
def test_conv_smallcin_pools_in_chunks(gen, dtype, pf):
    """K2 at Cin 8, F 256 with a pool past one halo staging (80 rows in
    bf16, 48 in float32): the window's rows go in chunks, the running max
    carried, and the result matches the plain version."""
    x = torch.randn(2, 8, 256, 300, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, 8, 80, generator=gen, device="cuda") / 72 ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(80, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(80, generator=gen, device="cuda")
    got = pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
    assert launch_counts["conv3x3_smallcin"] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin", [8, 10])
def test_conv_smallcin_chunk_is_the_kernels_limit(gen, dtype, cin):
    """The wrapper's chunk plan (smallcin_pool_chunks) hands the kernel its
    rows per staging. The kernel takes smallcin_max_pool_f rows and refuses
    one more, so the Python limit is the kernel's; and any chunking gives
    the same pooled output bit for bit (the running max is carried)."""
    top = pool.smallcin_max_pool_f(cin, dtype)
    pf = 2 * top + 2
    x = torch.randn(1, cin, pf, 40, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, 64, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(64, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(64, generator=gen, device="cuda")

    def launch(chunk):
        out = torch.empty(1, 64, 1, 40, dtype=dtype, device="cuda")
        err = _build.load().seld_conv3x3_smallcin(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            1, cin, pf, 40, 64, pf, chunk, dtype_code(x), stream_handle(x.device))
        return err, out

    assert launch(top + 1)[0] != 0
    outs = []
    for chunk in (top, 3):
        err, out = launch(chunk)
        assert err == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,cout,pf", [(2, 5, 24, 300, 80, 8), (2, 8, 8, 130, 64, 2),
                                               (2, 24, 12, 300, 80, 4), (1, 16, 4, 129, 200, 2)])
def test_conv_kernel(gen, dtype, b, cin, f, t, cout, pf):
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = conv2d_bn_relu_fpool(x, w, scale, bias, pf)
    name = "conv3x3_smallcin" if cin <= 8 else "conv3x3_widecin"
    assert launch_counts[name] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), dtype)


# (b, cin, f, t, cout, pf) for K3's tile, launched directly (any Cin): ragged
# Cin chunks (12, 24, 40 and 200 against chunks of 8 in float32 and 16 in
# bfloat16), ragged Cout tiles (80, 100, 200 against 64), ragged frame tiles
# (129 = 2 * 64 + 1, 193 = 3 * 64 + 1, 65, 300; 296 stages x by 16-byte
# loads, T % 8 == 0), pf 1-8 (the bf16 block tile's 4 row slots: one window
# in passes of 4, 4 / pf windows a block, a short last pass at pf 3 and 5,
# F not a multiple of 4 for dh), several blocks in every grid dimension
TILE_SHAPES = [(2, 12, 24, 300, 80, 8), (1, 24, 16, 129, 200, 4), (2, 200, 8, 300, 80, 2),
               (1, 24, 12, 296, 200, 2), (1, 40, 12, 65, 72, 3), (2, 16, 10, 193, 100, 5),
               (1, 24, 6, 257, 64, 1), (2, 12, 16, 129, 80, 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,cout,pf", TILE_SHAPES)
def test_conv_tile_ragged(gen, dtype, b, cin, f, t, cout, pf):
    """K3's kernel (the block tile: bfloat16 on mma.sync, float32 in split
    TF32) against its plain version at ragged shapes; then K9's dh pass (the
    block tile on the transposed weights, in both dtypes) on the same shapes
    (Cin and Cout swapped)."""
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = pool.conv2d_widecin_bn_relu_fpool(x, w, scale, bias, pf)
    assert launch_counts["conv3x3_widecin"] == 1
    _close(got, conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), dtype)
    gz = torch.randn(b, cout, f, t, generator=gen, device="cuda").to(dtype)
    _close(k9.ct_dx(gz, w), k9.ct_dx_plain(gz, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,d", [(2, 200, 3, 48), (1, 130, 2, 32), (1, 65, 1, 16),
                                     *((b, t, h, d) for t in (130, 200)
                                       for b, h, d in ((1, 4, 16), (2, 2, 32), (1, 3, 48),
                                                       (2, 1, 64), (1, 2, 128)))])
def test_flash_attention_kernel(gen, dtype, b, t, h, d):
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    out, lse = flash_attention(q, k, v, d ** -0.5)
    assert launch_counts["flash_attn_fwd"] == 1
    out_ref, lse_ref = flash_attention_plain(q, k, v, d ** -0.5)
    _close(out, out_ref, dtype)
    _close(lse, lse_ref, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,d", [(2, 200, 3, 8), (1, 130, 2, 24), (64, 300, 8, 24),
                                     (2, 200, 3, 160), (1, 130, 2, 256), (2, 65, 2, 320),
                                     (16, 300, 8, 160), (2, 65, 3, 136), (1, 130, 2, 192),
                                     (2, 200, 2, 224), (1, 200, 2, 320), (2, 130, 1, 512),
                                     (1, 65, 2, 512), (2, 200, 2, 300), (1, 130, 1, 600),
                                     (2, 65, 2, 288), (1, 200, 2, 480), (2, 130, 1, 640),
                                     (1, 65, 1, 1280)])
def test_flash_attention_padded_head_dims(gen, dtype, b, t, h, d):
    """Head dims without an instantiation run zero-padded (attention.
    head_dim_plan): 8 and 24 to the next one (16, 32); past 128, bfloat16 to a
    multiple of 32 in ceil(D / 256) column groups (136 -> 160, 300 -> 320 and
    600 -> 608; 320 and 512 in two equal groups; 288, 480, 600 and 640 with a
    narrower last group; 1280 in five), float32 the same (its wide kernels
    in split TF32). In bf16 the dk/dv pass streams K and V with each tile
    from D 600 on, the dq pass Q and dO from 640, the forward Q at 1280; in
    float32 the backward streams the pair in chunks from D 160, the block's
    own rows from 192 (dk/dv) and 224 (dq), and the forward takes 128-query
    blocks up to D 192 (K and V split at staging at 160), 64 past it, Q
    streamed from 480. K4, K6 and the autograd Function against
    their plain versions (bf16 2e-2 x max|ref|, float32 2e-4 x max|ref| with
    TF32 off), ragged key tiles (T 65, 130, 200); the 64 x 8 heads at T 300
    take K4's bf16 128-query blocks. K6 reruns bitwise equal (no atomics).
    The kernels launched are the dtype's own: past 128 the wide ones
    (``flash_*_wide_tc_kernel``, ``flash_*_wide_tf32_kernel``), and no other
    attention kernel."""
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
                     for _ in range(4))
    scale = d ** -0.5
    out, lse = flash_attention(q, k, v, scale)
    out_ref, lse_ref = flash_attention_plain(q, k, v, scale)
    assert out.shape == q.shape
    _close(out, out_ref, dtype)
    _close(lse, lse_ref, torch.float32)
    out_r, lse_r = out_ref.contiguous(), lse_ref.contiguous()
    got = flash_attention_bwd(q, k, v, out_r, dout, lse_r, scale)
    for a, b_ in zip(got, flash_attention_bwd_plain(q, k, v, out_r, dout, lse_r, scale)):
        assert a.shape == q.shape
        _close(a, b_, dtype)
    for a, b_ in zip(flash_attention_bwd(q, k, v, out_r, dout, lse_r, scale), got):
        assert torch.equal(a, b_)
    grads = []
    for fn in (flash_attention_train, attend_full):
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        (fn(*leaves, scale).float() * dout.float()).sum().backward()
        grads.append([a.grad for a in leaves])
    for a, b_ in zip(*grads):
        _close(a, b_, dtype)
    assert launch_counts["flash_attn_fwd"] == 2 and launch_counts["flash_attn_bwd"] == 3
    kind = ("wide_" if d > 128 else "") + ("tf32" if dtype == torch.float32 else "tc")
    fwd = _attention_kernels(lambda: flash_attention(q, k, v, scale))
    bwd = _attention_kernels(lambda: flash_attention_bwd(q, k, v, out_r, dout, lse_r, scale))
    assert len(fwd) == 1 and f"flash_fwd_{kind}_kernel" in fwd[0], fwd
    assert len(bwd) == 2 and all(any(f"flash_{p}_{kind}_kernel" in n for n in bwd)
                                 for p in ("dq", "dkv")), bwd


def _attention_kernels(fn) -> list:
    """The flash_* device kernels one fn() call launches, by the profiler's
    (demangled) names, from a capture checked whole (``device_events``)."""
    from seld_tpu_torch.utils.profiling import device_events

    return [e.key for e in device_events(fn)[0] if "flash_" in e.key]


def k5_inputs(gen, b, cin, f, t, cout, dtype):
    """K5 inputs on a grid: x in {-2..2}, w in {-4..4}/16, so every conv sum
    is exact in float32 and bfloat16 products: the kernel's conv and the
    plain one agree bit for bit, and the max-pool routes to the same row in
    both (random real inputs would leave a few near-ties that round apart).
    Exact ties are frequent, which exercises the first-max rule."""
    x = torch.randint(-2, 3, (b, f, t, cin), generator=gen, device="cuda").to(dtype)
    w = (torch.randint(-4, 5, (3, 3, cin, cout), generator=gen, device="cuda") / 16).to(dtype)
    gamma = 1.0 + 0.3 * torch.randn(cout, generator=gen, device="cuda")
    beta = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    return x, w, gamma, beta


K5_SHAPES = [(2, 8, 24, 1300, 200, 8),   # 3 T splits, 4 Cout tiles, B * F' = 6
             (2, 5, 24, 1100, 80, 8),    # Cin 5, 2 Cout tiles
             (3, 8, 12, 777, 80, 4),
             (2, 9, 16, 700, 80, 4),     # Cin 9 and 10: 16 staged channels (3 * Cin <= 32)
             (1, 10, 24, 1300, 72, 8),
             (1, 8, 32, 515, 64, 16)]    # T % 8 != 0 (2-byte staging), pool 16


def k5_launches(dtype) -> dict:
    """K5's launches for one forward and backward of the op: F2 is K2's kernel
    in float32 and K3's tile through K10b's entry in bfloat16; B2 is the g_z
    pass and the dW tile in both."""
    bf16 = dtype == torch.bfloat16
    return {"conv_train_stats": 1, "conv3x3_smallcin": int(not bf16),
            "conv3x3_windows": int(bf16), "conv_train_sel_stats": 1,
            "conv_train_gz": 1, "conv_train_dw": 1}


# the device kernels of one K5 forward and backward, by the profiler's names:
# float32 on the float smallcin tile (F1, F2 = K2's kernel, the g_z pass) and
# the split-TF32 dW tile, bfloat16 on the block, row and dW tiles
K5_KERNELS = {torch.float32: ("train_stats_tf32_kernel", "smallcin_tf32_kernel",
                              "sel_stats_kernel", "train_gz_tf32_kernel", "ct_dw_tf32_kernel"),
              torch.bfloat16: ("train_stats_tc_kernel", "conv3x3_tc_kernel", "sel_stats_kernel",
                               "train_gz_tc_kernel", "ct_dw_tc_kernel")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,cout,pf", K5_SHAPES)
def test_conv_train_op(gen, dtype, b, cin, f, t, cout, pf):
    """K5's kernels through the autograd op against autograd of the plain
    composition: out, mean, var, dW, dgamma, dbeta; one launch of each pass
    and, on a profiled rerun, each pass's kernel (K5_KERNELS) launched."""
    from seld_tpu_torch.utils.profiling import device_events

    x, w, gamma, beta = k5_inputs(gen, b, cin, f, t, cout, dtype)
    g = torch.randn(b, f // pf, t, cout, generator=gen, device="cuda").to(dtype)
    results = []
    for fn in (k5.conv2d_bn_relu_fpool_train, k5.conv2d_bn_relu_fpool_train_plain):
        wr, gr, br = (v.clone().requires_grad_() for v in (w, gamma, beta))
        out, mean, var = fn(x, wr, gr, br, pf)
        (out.float() * g.float()).sum().backward()
        results.append((out, mean, var, wr.grad, gr.grad, br.grad))
    want_launches = k5_launches(dtype)
    assert {n: launch_counts[n] for n in want_launches} == want_launches
    for got, want in zip(*results):
        _close(got, want, dtype if got.dtype == dtype else torch.float32)

    def step():
        wr, gr, br = (v.clone().requires_grad_() for v in (w, gamma, beta))
        out = k5.conv2d_bn_relu_fpool_train(x, wr, gr, br, pf)[0]
        (out.float() * g.float()).sum().backward()

    names = [e.key for e in device_events(step)[0]]
    assert all(any(k in n for n in names) for k in K5_KERNELS[dtype]), names


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,cout,pf", [*K5_SHAPES[:2], *K5_SHAPES[3:]])
def test_conv_train_passes(gen, dtype, b, cin, f, t, cout, pf):
    """Each K5 pass against its plain version on the same inputs: float32's
    F1, F2 (K2's kernel) and g_z pass on the float smallcin tile and its
    split-TF32 dW tile (also within 4x the float32 plain version's distance
    from float64), bfloat16's tensor-core ones (F2 K3's tile through K10b's
    entry); B2 the g_z pass and the dW tile in both."""
    x, w, _, _ = k5_inputs(gen, b, cin, f, t, cout, dtype)
    x = x.permute(0, 3, 1, 2).contiguous()
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    _close(k5.conv_train_stats(x, w, pf), k5.conv_train_stats_plain(x, w), torch.float32)
    bf16 = dtype == torch.bfloat16
    f2 = pool.conv2d_windows_bn_relu_fpool if bf16 else pool.conv2d_smallcin_bn_relu_fpool
    out = f2(x, w, scale, bias, pf)
    _close(out, k5.conv_train_fwd_plain(x, w, scale, bias, pf), dtype)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    p, q = 0.5 + torch.rand(cout, generator=gen, device="cuda"), torch.randn(
        cout, generator=gen, device="cuda")
    _close(k5.sel_stats(out, g, p, q), k5.sel_stats_plain(out, g, p, q), torch.float32)
    a, c = 1e-3 * torch.randn(cout, generator=gen, device="cuda"), 1e-3 * torch.randn(
        cout, generator=gen, device="cuda")
    args = (x, w, g, scale, bias, a, c, pf)
    gz, sums = k5.conv_train_gz(*args)
    want_gz, want_sums = k5.conv_train_gz_plain(*args)
    _close(gz, want_gz, dtype)
    _close(sums, want_sums, torch.float32)
    dw = k5.conv_train_dw_gz(x, gz)
    _close(dw, k5.dw_plain(x, gz), torch.float32)
    if not bf16:
        _f64_gate(f"K5 dW {b}x{cin}x{f}x{t}->{cout}", dw, _dw_plain_f32(x, gz),
                  k5.dw_plain(x.double(), gz.double()))
    assert [launch_counts[n] for n in ("conv_train_gz", "conv_train_dw")] == [1, 1]
    # partial sums reduced in a fixed order, no atomics: a rerun is bitwise equal
    assert torch.equal(k5.conv_train_dw_gz(x, gz), dw)
    for a_, b_ in zip(k5.conv_train_gz(*args), (gz, sums)):
        assert torch.equal(a_, b_)
    assert torch.equal(k5.conv_train_stats(x, w, pf), k5.conv_train_stats(x, w, pf))


def test_conv_train_bf16_routing_equals_f2_bitwise(gen):
    """On random (not integer-grid) bf16 inputs: K5's F2 pools max_r relu(pre *
    scale + bias) of the tile's rows (K9 F1's pre, the same tile) bit for bit,
    and K5's g_z pass, fed g = 1 and a = b = 0 (g_z = scale > 0 exactly where
    it routes), routes each window to the first row holding that max, where
    the max is > 0."""
    b, cin, f, t, cout, pf = 2, 8, 64, 1000, 80, 8
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / 72 ** 0.5).to(
        torch.bfloat16)
    scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bias = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    pre = k9.ct_train_stats(x, w, pf)[1]
    y = (pre.double() * scale.double()[:, None, None] + bias.double()[:, None, None]).float()
    y = torch.relu(y).view(b, cout, f // pf, pf, t)
    best, row = y[:, :, :, 0], torch.zeros_like(y[:, :, :, 0], dtype=torch.long)
    for r in range(1, pf):
        up = y[:, :, :, r] > best
        best, row = torch.where(up, y[:, :, :, r], best), torch.where(up, r, row)
    assert torch.equal(pool.conv2d_windows_bn_relu_fpool(x, w, scale, bias, pf),
                       best.to(torch.bfloat16))
    want = (torch.arange(pf, device="cuda").view(1, 1, 1, pf, 1) == row.unsqueeze(3)) & (
        best > 0).unsqueeze(3)
    zero = torch.zeros(cout, device="cuda")
    ones = torch.ones(b, cout, f // pf, t, dtype=torch.bfloat16, device="cuda")
    gz, sums = k5.conv_train_gz(x, w, ones, scale, bias, zero, zero, pf)
    assert torch.equal((gz != 0).view(want.shape), want)
    assert torch.equal(sums[:cout], want.sum((0, 2, 3, 4)).float())


def _fma_f32(a, b, c):
    """a * b + c rounded once to float32, as fmaf: the float64 product is
    exact and the float64 sum's error is recovered (two-sum), which decides
    the rounding where that sum falls on a midpoint between two floats."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    y = s.float()
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.full_like(y, -float("inf")))
    y = torch.where(((y.double() + up.double()) / 2 == s) & (err > 0), up, y)
    return torch.where(((y.double() + down.double()) / 2 == s) & (err < 0), down, y)


def test_conv_train_f32_routing_equals_f2_bitwise(gen):
    """The float32 twin, with K2's kernel as F2: on random (not
    integer-grid) float32 inputs at Cin 8 and 10 (8 and 16 staged
    channels), K5's float32 g_z pass, fed g = 1 and a = b = 0 (g_z = scale
    exactly where it routes, 0 elsewhere), routes each window once where
    F2's pooled max is > 0 and nowhere else; at Cin 8 F2 pools max_r
    relu(pre * scale + bias) of the float smallcin tile's conv rows bit for
    bit (pre: the g_z pass's own recompute, fed g = 0, a = -1 and b = 0, so
    that g_z = acc exactly), and the pass routes to the first row holding
    that max."""
    b, f, t, cout, pf = 2, 64, 1000, 80, 8
    for cin in (8, 10):
        x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
        w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
        scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
        bias = 0.3 * torch.randn(cout, generator=gen, device="cuda")
        out = pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
        zero = torch.zeros(cout, device="cuda")
        ones = torch.ones(b, cout, f // pf, t, device="cuda")
        gz, sums = k5.conv_train_gz(x, w, ones, scale, bias, zero, zero, pf)
        routed = (gz != 0).view(b, cout, f // pf, pf, t)
        assert int(routed.sum(3).max()) <= 1
        assert torch.equal(routed.any(3), out > 0)
        at = scale.view(1, cout, 1, 1, 1).expand(routed.shape)
        assert torch.equal(gz.view(routed.shape)[routed], at[routed])
        assert torch.equal(sums[:cout], (out > 0).sum((0, 2, 3)).float())
        if cin != 8:
            continue
        pre = k5.conv_train_gz(x, w, torch.zeros_like(ones), scale, bias, -torch.ones_like(zero),
                               zero, pf)[0]
        y = torch.relu(_fma_f32(pre, scale[:, None, None], bias[:, None, None]))
        y = y.view(b, cout, f // pf, pf, t)
        best, row = y[:, :, :, 0], torch.zeros_like(y[:, :, :, 0], dtype=torch.long)
        for r in range(1, pf):
            up = y[:, :, :, r] > best
            best, row = torch.where(up, y[:, :, :, r], best), torch.where(up, r, row)
        assert torch.equal(out, best)
        want = (torch.arange(pf, device="cuda").view(1, 1, 1, pf, 1) == row.unsqueeze(3)) & (
            best > 0).unsqueeze(3)
        assert torch.equal(routed, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin", [8, 10])
def test_conv_train_op_at_the_top_pool(gen, dtype, cin):
    """K5 at its largest pool_f (conv2d_train.max_pool_f: 255 rows, the g_z
    passes' routed row in a byte; float32's passes walk it in stagings of 42
    rows at Cin <= 8 and 16 at Cin 9-10), in both dtypes: the op's outputs
    and gradients against the plain composition, every pass launched once."""
    pf = k5.max_pool_f(cin)
    assert pf == 255
    b, f, t, cout = 2, 2 * pf, 300, 72
    x, w, gamma, beta = k5_inputs(gen, b, cin, f, t, cout, dtype)
    g = torch.randn(b, f // pf, t, cout, generator=gen, device="cuda").to(dtype)
    results = []
    for fn in (k5.conv2d_bn_relu_fpool_train, k5.conv2d_bn_relu_fpool_train_plain):
        wr, gr, br = (v.clone().requires_grad_() for v in (w, gamma, beta))
        out, mean, var = fn(x, wr, gr, br, pf)
        (out.float() * g.float()).sum().backward()
        results.append((out, mean, var, wr.grad, gr.grad, br.grad))
    want_launches = k5_launches(dtype)
    assert {n: launch_counts[n] for n in want_launches} == want_launches
    for got, want in zip(*results):
        _close(got, want, dtype if got.dtype == dtype else torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,d", [(2, 200, 3, 48), (1, 130, 2, 32), (1, 65, 1, 16),
                                     (2, 200, 1, 64), (1, 130, 2, 128)])
def test_flash_attention_bwd_kernel(gen, dtype, b, t, h, d):
    """K6 at every head dim of HEAD_DIMS, ragged multi-tile T; two passes and
    no atomics, so a rerun is bitwise equal."""
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
                     for _ in range(4))
    out, lse = (t.contiguous() for t in flash_attention_plain(q, k, v, d ** -0.5))
    got = flash_attention_bwd(q, k, v, out, dout, lse, d ** -0.5)
    assert launch_counts["flash_attn_bwd"] == 1
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, d ** -0.5)
    for a, b_ in zip(got, want):
        _close(a, b_, dtype)
    for a, b_ in zip(flash_attention_bwd(q, k, v, out, dout, lse, d ** -0.5), got):
        assert torch.equal(a, b_)


# K4 / K6 in float32 (split TF32): every instantiated head dim, and past 128
# the wide kernels at D 160 (K4's 128-query blocks, K and V split at staging;
# K6's pair in two chunks) and 256 (K4's 64-query blocks, split as read; K6
# streaming the block's rows), at T 65 (one ragged tile), 200 (three and a
# ragged tail) and the flagship's 2400 (38 tiles)
K6_F32_CASES = [(b, t, h, d) for d in (16, 32, 48, 64, 128, 160, 256)
                for b, t, h in ((2, 65, 3), (1, 200, 2), (1, 2400, 2))]


def _f64_gate(name, got, plain, exact):
    """max|d| from float64 of a split-TF32 kernel's output within 4x the
    float32 plain version's (TF32 off); both printed (``pytest -s``)."""
    d_kernel, d_plain = ((a.double() - exact).abs().max().item() for a in (got, plain))
    print(f"[f64] {name}: kernel {d_kernel:.3e}, float32 plain {d_plain:.3e} "
          f"({d_kernel / max(d_plain, 1e-300):.2f}x; gate 4x)")
    assert d_kernel <= 4 * d_plain, (name, d_kernel, d_plain)


@pytest.mark.parametrize("b,t,h,d", K6_F32_CASES)
def test_flash_attention_bwd_tf32(gen, b, t, h, d):
    """K6's float32 passes (flash_dq_tf32_kernel, flash_dkv_tf32_kernel; past
    128 their wide counterparts) against the plain version in float32, TF32
    off; each gradient within 4x the plain version's distance from float64;
    bitwise on a rerun."""
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(4))
    out, lse = (a.contiguous() for a in flash_attention_plain(q, k, v, d ** -0.5))
    got = flash_attention_bwd(q, k, v, out, dout, lse, d ** -0.5)
    assert launch_counts["flash_attn_bwd"] == 1
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, d ** -0.5)
    exact = flash_attention_bwd_plain(*(a.double() for a in (q, k, v, out, dout, lse)),
                                      d ** -0.5)
    for n, a, b_, e in zip(("dq", "dk", "dv"), got, want, exact):
        _f64_gate(f"K6 D {d} T {t} {n}", a, b_, e)
        _close(a, b_, torch.float32)
    for a, b_ in zip(flash_attention_bwd(q, k, v, out, dout, lse, d ** -0.5), got):
        assert torch.equal(a, b_)


def _put_nan(x, at, bits):
    """x with the float32 whose bits are ``bits`` (a NaN) at index ``at``."""
    x = x.clone()
    x.view(torch.int32)[at] = bits
    return x


# float('nan') and the card's own NaN, 0x7fffffff, whose rounding to TF32 by
# the bits plus half an ulp would carry into the sign and give a zero
NAN_BITS = [0x7FC00000, 0x7FFFFFFF]


@pytest.mark.parametrize("bits", NAN_BITS)
@pytest.mark.parametrize("d", [48, 128, 160, 256])
def test_flash_attention_bwd_tf32_keeps_nans(gen, bits, d):
    """A NaN in q (batch 0) or in dO (batch 1) of K6's float32 passes comes
    out NaN exactly where the plain version's does: out and lse are those of
    the finite inputs, so only the split operands carry it."""
    b, t, h = 2, 200, 2
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(4))
    out, lse = (a.contiguous() for a in flash_attention_plain(q, k, v, d ** -0.5))
    q, dout = _put_nan(q, (0, 70, 1, 5), bits), _put_nan(dout, (1, 131, 0, 9), bits)
    got = flash_attention_bwd(q, k, v, out, dout, lse, d ** -0.5)
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, d ** -0.5)
    for a, b_ in zip(got, want):
        assert bool(torch.isnan(b_[0]).any()) and bool(torch.isnan(b_[1]).any())
        assert torch.equal(torch.isnan(a), torch.isnan(b_))


@pytest.mark.parametrize("b,t,h,d", K6_F32_CASES)
def test_flash_attention_fwd_tf32(gen, b, t, h, d):
    """K4's float32 forward (flash_fwd_tf32_kernel: K and V split at staging
    up to D 64, as read at D 128; past 128 flash_fwd_wide_tf32_kernel, split
    at staging at D 160, as read at 256) against the plain version in
    float32, TF32 off: out and lse
    within 4x the plain version's distance from float64, within 2e-4 x max
    of it, one launch, and bitwise on a rerun."""
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3))
    scale = d ** -0.5
    got = flash_attention(q, k, v, scale)
    assert launch_counts["flash_attn_fwd"] == 1
    want = flash_attention_plain(q, k, v, scale)
    exact = flash_attention_plain(q.double(), k.double(), v.double(), scale)
    for n, a, b_, e in zip(("out", "lse"), got, want, exact):
        _f64_gate(f"K4 D {d} T {t} {n}", a, b_, e)
        _close(a, b_, torch.float32)
    for a, b_ in zip(flash_attention(q, k, v, scale), got):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("bits", NAN_BITS)
@pytest.mark.parametrize("d", [48, 128, 160, 256])
def test_flash_attention_fwd_tf32_keeps_nans(gen, bits, d):
    """A NaN in q (batch 0), k (batch 1) or v (batch 2) of K4's float32
    forward comes out NaN in out and lse exactly where the plain version's
    does: q's row, all of k's (b, h), v's column."""
    b, t, h = 3, 200, 2
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3))
    q, k = _put_nan(q, (0, 70, 1, 5), bits), _put_nan(k, (1, 131, 0, 9), bits)
    v = _put_nan(v, (2, 17, 1, 3), bits)
    got = flash_attention(q, k, v, d ** -0.5)
    want = flash_attention_plain(q, k, v, d ** -0.5)
    for bb in range(b):
        assert bool(torch.isnan(want[0][bb]).any()) and not bool(torch.isnan(want[0][bb]).all())
    for a, b_ in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b_))


def test_cuda_tensors_never_take_the_plain_path(gen):
    """A CUDA tensor launches or raises: mixed devices and unsupported shapes
    raise instead of running the plain version."""
    x = torch.randn(1, 12, 8, 20, generator=gen, device="cuda")
    w = torch.randn(3, 3, 12, 8, generator=gen, device="cuda")
    s = torch.ones(8, device="cuda")
    with pytest.raises(ValueError):
        conv2d_bn_relu_fpool(x[:, :8], w[:, :, :8].cpu(), s, s, 2)
    q = torch.zeros(1, 1, 65536, 16, device="cuda")
    with pytest.raises(ValueError):   # B * H past the grid's y range
        flash_attention(q, q, q, 0.2)
    assert all(v == 0 for v in launch_counts.values())
    # a pool past one float32 halo staging (48 rows) and head dims 24 and 160 run
    # on the kernels (in chunks; 24 zero-padded to 32, 160 on the wide kernel
    # unpadded) and match the plain versions
    x4, w4 = torch.randn(1, 4, 50, 20, generator=gen, device="cuda"), w[:, :, :4].contiguous()
    _close(conv2d_bn_relu_fpool(x4, w4, s, s, 50), conv2d_bn_relu_fpool_plain(x4, w4, s, s, 50),
           torch.float32)
    for d in (24, 160):
        q = torch.randn(1, 10, 2, d, generator=gen, device="cuda")
        _close(flash_attention(q, q, q, 0.2)[0], flash_attention_plain(q, q, q, 0.2)[0],
               torch.float32)
    assert launch_counts["conv3x3_smallcin"] == 1 and launch_counts["flash_attn_fwd"] == 2


def test_fused_frontend_raises_where_k5_cannot_run(gen):
    """frontend_impl='fused' on a CUDA tensor takes K5 or raises: a stage 0
    with a biased conv does not fall back to the plain stage."""
    from seld_tpu_torch.models.blocks import ConvTCBlock

    block = ConvTCBlock("DQ", 8, 16, [16], 3, [[2, 1]], "CNN", [1], "fibonacci", 16, 16, 3,
                        [16, 16], 3, use_bias=True, batch_norm="BN", attention_impl="full",
                        frontend_impl="fused", device="cuda",
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 8, 8, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="K5 conditions"):
        block(x, train=True, generator=gen)
    assert all(v == 0 for v in launch_counts.values())
    x11 = torch.randn(1, 4, 4, 11, device="cuda")   # 3 * Cin > 32: beyond K5 on a CUDA tensor
    ones = torch.ones(8, device="cuda")
    with pytest.raises(ValueError):
        k5.conv2d_bn_relu_fpool_train(x11, torch.zeros(3, 3, 11, 8, device="cuda"), ones, ones, 2)
    with pytest.raises(ValueError):   # K2's 16-channel staging stops at Cin 10 too
        pool.conv2d_smallcin_bn_relu_fpool(x11.permute(0, 3, 1, 2).contiguous(),
                                           torch.zeros(3, 3, 11, 8, device="cuda"), ones, ones, 2)
    assert all(v == 0 for v in launch_counts.values())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frontend_impl", ["fused", "ct"])
def test_frontends_run_k5_at_cin_10(gen, frontend_impl, dtype):
    """frontend_impl 'fused' and 'ct' on a CUDA tensor with 10 input
    channels (the reference's 3 * Cin <= 32) run K5 instead of raising; its
    F2 is K2's kernel in float32 and K3's tile (K10b's entry) in bfloat16."""
    from seld_tpu_torch.models.blocks import ConvTCBlock

    block = ConvTCBlock("R", 10, 16, [8, 16], 3, [[2, 1], [2, 1]], "CNN", [1], "fibonacci", 16,
                        16, 3, [16, 16], 3, use_bias=False, batch_norm="BN",
                        attention_impl="full", frontend_impl=frontend_impl, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    block = block.to(dtype)
    x = torch.randn(2, 16, 40, 10, generator=gen, device="cuda").to(dtype)
    out = block(x, train=True, generator=gen)
    assert bool(torch.isfinite(out).all())
    f2 = "conv3x3_windows" if dtype == torch.bfloat16 else "conv3x3_smallcin"
    assert [launch_counts[n] for n in ("conv_train_stats", f2)] == [1, 1]
    assert launch_counts["ct_train_stats"] == (frontend_impl == "ct")


K9_SHAPES = [(2, 24, 24, 300, 72, 8),    # 3 T tiles, 2 Cout tiles, 3 pool groups, 3 Cin chunks
             (3, 16, 12, 777, 200, 4),   # Cout 200: 4 Cout tiles, the last ragged
             (2, 8, 8, 130, 12, 2)]      # Cout 12: not a multiple of 8


def k9_inputs(gen, b, c, f, t, cout, dtype):
    """K9 inputs on a grid (k5_inputs' reason), h (B, C, F, T)."""
    h = torch.randint(-2, 3, (b, c, f, t), generator=gen, device="cuda").to(dtype)
    w = (torch.randint(-4, 5, (3, 3, c, cout), generator=gen, device="cuda") / 16).to(dtype)
    gamma = 1.0 + 0.3 * torch.randn(cout, generator=gen, device="cuda")
    beta = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    return h, w, gamma, beta


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,f,t,cout,pf", K9_SHAPES)
def test_conv_ct_train_op(gen, dtype, b, c, f, t, cout, pf):
    """K9's five kernels and K3 through the autograd op against autograd of
    the plain composition: out, mean, var, dh, dW, dgamma, dbeta."""
    h, w, gamma, beta = k9_inputs(gen, b, c, f, t, cout, dtype)
    g = torch.randn(b, cout, f // pf, t, generator=gen, device="cuda").to(dtype)
    results = []
    for fn in (k9.conv2d_ct_bn_relu_fpool_train, k9.conv2d_ct_bn_relu_fpool_train_plain):
        leaves = [v.clone().requires_grad_() for v in (h, w, gamma, beta)]
        out, mean, var = fn(*leaves, pf)
        (out.float() * g.float()).sum().backward()
        results.append((out, mean, var, *(v.grad for v in leaves)))
    # F2 is K3's widecin kernel fed the batch-statistics affine, whatever C is
    assert [launch_counts[n] for n in ("ct_train_stats", "conv3x3_widecin", "ct_train_sel_stats",
                                       "ct_train_gz", "ct_train_dw", "ct_train_dx")] == [1] * 6
    for got, want in zip(*results):
        _close(got, want, dtype if got.dtype == dtype else torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,f,t,cout,pf", [
    *K9_SHAPES[:2],
    (1, 16, 4, 1000, 72, 2),   # B * F = 4 (as stage 3): dW splits each row's frames 16 ways
    (2, 24, 4, 515, 12, 2),    # the same at T % 8 != 0 (2-byte staging), Cin 24, Cout 12
])
def test_conv_ct_train_passes(gen, dtype, b, c, f, t, cout, pf):
    """Each K9 pass against its plain version on the same inputs; F1's conv
    rows equal F2's (K3's) bit for bit."""
    h, w, gamma, beta = k9_inputs(gen, b, c, f, t, cout, dtype)
    sums, pre = k9.ct_train_stats(h, w, pf)
    want_sums, want_pre = k9.ct_train_stats_plain(h, w)
    _close(sums, want_sums, torch.float32)
    _close(pre, want_pre, torch.float32)
    # F2 (K3) with the identity affine pools F1's rows bit for bit, also on
    # real-valued inputs, where another summation order would round apart
    one, zero = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
    hr = torch.randn(h.shape, generator=gen, device="cuda").to(dtype)
    wr = (torch.randn(w.shape, generator=gen, device="cuda") / (9 * c) ** 0.5).to(dtype)
    pre_r = k9.ct_train_stats(hr, wr, pf)[1]
    want = torch.nn.functional.max_pool2d(torch.relu(pre_r), (pf, 1)).to(dtype)
    assert torch.equal(conv2d_bn_relu_fpool(hr, wr, one, zero, pf), want)
    out = conv2d_bn_relu_fpool(h, w, one, zero, pf)
    scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    cols = torch.stack([scale, bias, 0.1 * torch.randn(cout, generator=gen, device="cuda"),
                        0.5 + torch.rand(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda")])
    _close(k9.ct_sel_stats(pre, g, cols, pf), k9.ct_sel_stats_plain(pre, g, cols, pf),
           torch.float32)
    gz = k9.ct_gz(pre, g, cols, pf)
    _close(gz, k9.ct_gz_plain(pre, g, cols, pf), dtype)
    dw = k9.ct_dw(h, gz)
    _close(dw, k5.dw_plain(h, gz), torch.float32)
    _close(k9.ct_dx(gz, w), k9.ct_dx_plain(gz, w), dtype)
    # partial sums reduced in a fixed order, no atomics: a rerun is bitwise equal
    assert torch.equal(k9.ct_dw(h, gz), dw)


# K9's B1 and g_z (the streaming walker): (B, Cout, F, T, pf, g misaligned). T %
# 4 != 0 walks one frame at a time (130, 515, 777), T % 4 == 0 in 16-byte quads
# (300, 4800), as does a g view one element off its 16-byte boundary; pf 1, 2
# and 3 take two quads a lane, 8 and 16 one (16 in two chunks of rows); B * F'
# <= 4 (as stage 3) splits each window's frames into spans
ROUTE_CASES = [(2, 72, 16, 130, 1, False), (2, 72, 16, 515, 2, False),
               (1, 40, 24, 777, 3, False), (2, 72, 16, 300, 8, False),
               (1, 24, 32, 4800, 16, False), (2, 40, 16, 300, 16, True),
               (2, 40, 24, 777, 8, False), (2, 72, 16, 130, 16, False),
               (1, 72, 4, 1000, 2, False), (2, 192, 4, 4800, 2, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cout,f,t,pf,shifted", ROUTE_CASES)
def test_ct_route_passes(gen, dtype, b, cout, f, t, pf, shifted):
    """K9's B1 and g_z against their plain versions, one launch each a call,
    B1 bitwise on a rerun. pre on a grid of quarters puts ties in most
    windows; scale and bias on grids make the kernels' fused pre * scale +
    bias equal the plain version's, so both route alike."""
    pre = torch.randint(-8, 9, (b, cout, f, t), generator=gen, device="cuda").float() / 4
    grid = lambda lo, hi, step: torch.randint(lo, hi, (cout,), generator=gen,
                                              device="cuda").float() * step
    cols = torch.stack([0.5 + grid(0, 9, 1 / 8), grid(-4, 5, 1 / 16),
                        0.1 * torch.randn(cout, generator=gen, device="cuda"),
                        0.5 + torch.rand(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda")])
    size = b * cout * (f // pf) * t
    flat = torch.randn(size + 1, generator=gen, device="cuda").to(dtype)
    g = (flat[1:] if shifted else flat[:size]).view(b, cout, f // pf, t)
    sel = k9.ct_sel_stats(pre, g, cols, pf)
    _close(sel, k9.ct_sel_stats_plain(pre, g, cols, pf), torch.float32)
    assert torch.equal(k9.ct_sel_stats(pre, g, cols, pf), sel)
    gz = k9.ct_gz(pre, g, cols, pf)
    _close(gz, k9.ct_gz_plain(pre, g, cols, pf), dtype)
    assert gz.dtype == dtype
    assert [launch_counts[n] for n in ("ct_train_sel_stats", "ct_train_gz")] == [2, 1]


def _dw_plain_f32(h, gz):
    """dW in float32 without cuDNN (im2col and a float32 GEMM, TF32 off):
    cuDNN's float32 wgrad at the flagship's stage 2 is no float32-faithful
    reference (its distance from float64 is ~300x the kernel's)."""
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return k5.dw_plain(h, gz)


@pytest.mark.parametrize("b,c,f,t,cout", [s[:5] for s in K9_SHAPES] + [(2, 192, 32, 4800, 192)])
def test_ct_dw_tf32(gen, b, c, f, t, cout):
    """K9's float32 dW pass (ct_dw_tf32_kernel) at K9_SHAPES (T 777 and 130
    stage frame by frame) and at the flagship's stage 2 (batch 2, 307,200
    frames of depth) on real-valued h and g_z: within 2e-4 x max of the
    plain version (cuDNN's float32 wgrad, TF32 off), within 4x the float32
    plain version's distance from float64 (without cuDNN), and bitwise on a
    rerun."""
    h = torch.randn(b, c, f, t, generator=gen, device="cuda")
    gz = torch.randn(b, cout, f, t, generator=gen, device="cuda") / 100
    got = k9.ct_dw(h, gz)
    assert launch_counts["ct_train_dw"] == 1
    _f64_gate(f"K9 dW {b}x{c}x{f}x{t}->{cout}", got, _dw_plain_f32(h, gz),
              k5.dw_plain(h.double(), gz.double()))
    _close(got, k5.dw_plain(h, gz), torch.float32)
    assert torch.equal(k9.ct_dw(h, gz), got)


@pytest.mark.parametrize("bits", NAN_BITS)
def test_ct_dw_tf32_keeps_nans(gen, bits):
    """A NaN in h (batch 0) or in g_z (batch 1) of K9's float32 dW comes out
    NaN exactly where the plain version's does (without cuDNN)."""
    b, c, f, t, cout = 2, 24, 8, 130, 40
    h = _put_nan(torch.randn(b, c, f, t, generator=gen, device="cuda"), (0, 5, 3, 60), bits)
    gz = _put_nan(torch.randn(b, cout, f, t, generator=gen, device="cuda"), (1, 17, 6, 99), bits)
    got, want = k9.ct_dw(h, gz), _dw_plain_f32(h, gz)
    assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def _dx_plain_f32(gz, w):
    """dh in float32 without cuDNN (a float32 GEMM and col2im, TF32 off): the
    float32 plain version of dh's float64 gate and NaN check, whatever
    algorithm cuDNN's dgrad would pick."""
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return k9.ct_dx_plain(gz, w)


# K9's float32 dh (ct_dx_tf32_kernel): (b, cin, f, t, cout), several blocks in
# every grid dimension (64-frame tiles, 64-channel tiles of dh's Cin, passes
# of 4 rows): Cout 100 and 72 (a ragged last gz chunk of 4; 9 whole chunks),
# Cin 12 / 200 (ragged dh channels), T 65 / 257 / 300 (one frame in the last
# tile; T % 4 != 0: 4-byte staging and single stores; 16-byte staging and
# float2 stores), F 6 / 10 (a short last pass)
CT_DX_TF32_CASES = [(2, 12, 10, 300, 100), (1, 200, 6, 257, 72), (2, 24, 6, 65, 100),
                    (3, 200, 10, 300, 100)]


@pytest.mark.parametrize("b,cin,f,t,cout", CT_DX_TF32_CASES)
def test_ct_dx_tf32(gen, b, cin, f, t, cout):
    """K9's float32 dh (the split-TF32 block tile on the transposed weights)
    on real-valued gz and w: one launch, within 4x the float32 plain
    version's distance from float64, within 2e-4 x max of ct_dx_plain, and
    bitwise on a rerun."""
    gz = torch.randn(b, cout, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cout) ** 0.5
    got = k9.ct_dx(gz, w)
    assert launch_counts["ct_train_dx"] == 1
    _f64_gate(f"K9 dh {b}x{cout}x{f}x{t}->{cin}", got, _dx_plain_f32(gz, w),
              k9.ct_dx_plain(gz.double(), w.double()))
    _close(got, k9.ct_dx_plain(gz, w), torch.float32)
    assert torch.equal(k9.ct_dx(gz, w), got)


@pytest.mark.parametrize("bits", NAN_BITS)
def test_ct_dx_tf32_keeps_nans(gen, bits):
    """A NaN in gz (batch 0 inside a tile, batch 1 at the last frame of the
    last gz channel) of K9's float32 dh comes out NaN exactly where the plain
    version's does (without cuDNN), and the rest within tolerance."""
    b, cin, f, t, cout = 2, 72, 10, 300, 100
    gz = torch.randn(b, cout, f, t, generator=gen, device="cuda")
    gz = _put_nan(_put_nan(gz, (0, 5, 3, 60), bits), (1, cout - 1, 9, t - 1), bits)
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cout) ** 0.5
    got, want = k9.ct_dx(gz, w), _dx_plain_f32(gz, w)
    assert launch_counts["ct_train_dx"] == 1
    nan = torch.isnan(want)
    assert bool(nan[0].any()) and bool(nan[1].any()) and not bool(nan.all())
    assert torch.equal(torch.isnan(got), nan)
    _close(got.masked_fill(nan, 0), want.masked_fill(nan, 0), torch.float32)


@pytest.mark.parametrize("bits", NAN_BITS)
def test_conv_train_f32_b2_keeps_nans(gen, bits):
    """A NaN in x (batch 0) or in g (batch 1) of K5's float32 g_z pass, and
    in x (batch 0) or in g_z (batch 1) of its dW tile, comes out NaN exactly
    where the plain version's does (the dW tile's: without cuDNN). A NaN in
    x reaches every channel of g_z around it, and through g_z every weight,
    so the dW tile takes a g_z of its own."""
    b, cin, f, t, cout, pf = 2, 8, 16, 300, 72, 8
    x, w, _, _ = k5_inputs(gen, b, cin, f, t, cout, torch.float32)
    x = _put_nan(x.permute(0, 3, 1, 2).contiguous(), (0, 3, 5, 100), bits)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias, a, c = (0.2 * torch.randn(cout, generator=gen, device="cuda") for _ in range(3))
    g = _put_nan(torch.randn(b, cout, f // pf, t, generator=gen, device="cuda"),
                 (1, 40, 1, 250), bits)
    args = (x, w, g, scale, bias, a, c, pf)
    gz = k5.conv_train_gz(*args)[0]
    want_gz = k5.conv_train_gz_plain(*args)[0]
    assert bool(torch.isnan(want_gz[0]).any()) and bool(torch.isnan(want_gz[1]).any())
    assert torch.equal(torch.isnan(gz), torch.isnan(want_gz))
    x = _put_nan(torch.randn(x.shape, generator=gen, device="cuda"), (0, 3, 5, 100), bits)
    gz = _put_nan(torch.randn(gz.shape, generator=gen, device="cuda"), (1, 17, 6, 99), bits)
    got, want = k5.conv_train_dw_gz(x, gz), _dw_plain_f32(x, gz)
    assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.parametrize("b,cin,f,t,cout", [(2, 5, 24, 1100, 80), (2, 8, 24, 1300, 200),
                                            (2, 9, 16, 700, 80), (1, 10, 24, 1300, 72),
                                            (1, 8, 4, 515, 12), (2, 8, 256, 4800, 192)])
def test_conv_train_dw_tf32(gen, b, cin, f, t, cout):
    """K5's float32 dW tile (ct_dw_tf32_kernel<8>, the dx taps stacked, at
    Cin 5 and 8; <16> at Cin 9 and 10) at ragged multi-tile shapes (Cout
    tiles ragged, T 515 staged frame by frame, B * F = 4 splitting each
    row's frames) and at the flagship's stage 1 (batch 2, 2,457,600 frames
    of depth) on real-valued x and g_z: within 4x the float32 plain
    version's distance from float64 and within 2e-4 x max of it (both
    without cuDNN: cuDNN's float32 wgrad over this depth strays further than
    2e-4 x max from float64), and bitwise on a rerun."""
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    gz = torch.randn(b, cout, f, t, generator=gen, device="cuda") / 100
    got = k5.conv_train_dw_gz(x, gz)
    assert launch_counts["conv_train_dw"] == 1
    plain = _dw_plain_f32(x, gz)
    _f64_gate(f"K5 dW {b}x{cin}x{f}x{t}->{cout}", got, plain,
              k5.dw_plain(x.double(), gz.double()))
    _close(got, plain, torch.float32)
    assert torch.equal(k5.conv_train_dw_gz(x, gz), got)


# the float smallcin tile (K2 in float32, K5's float32 F1, F2 and g_z pass):
# (b, cin, f, t, cout, pf) at Cin 1, 5, 8, 9 and 10 (one or two 8-channel
# chunks), T ragged against the 128-frame tile and the two tiles a block walks
# (129, 300, 515 staged frame by frame, 1300 by 16-byte copies), Cout ragged
# against 64 (72, 80, 200), several blocks in every grid dimension, pf 1, 8
# and 16, the stagings' limits (42 rows at Cin <= 8, 16 at 9-10: pf 48 and 21
# run in two chunks) and the SIMT passes' old top pools (48, 21)
SCF_CASES = [(2, 1, 8, 300, 72, 1), (2, 5, 24, 1300, 80, 8), (3, 8, 32, 515, 200, 16),
             (1, 8, 96, 129, 72, 48), (2, 9, 16, 300, 80, 8), (1, 10, 42, 1300, 72, 21),
             (2, 10, 16, 129, 200, 16), (2, 8, 42, 300, 64, 42)]


@pytest.mark.parametrize("b,cin,f,t,cout,pf", SCF_CASES)
def test_smallcin_tf32(gen, b, cin, f, t, cout, pf):
    """The float smallcin tile on real-valued inputs: K2 in float32
    (smallcin_tf32_kernel) within 4x the float32 plain version's distance
    from float64 and 2e-4 x max of it, bit for bit K10b's float32 output
    (the block tile, one K walk), bitwise on a rerun; K5's F1
    (train_stats_tf32_kernel) sums within 2e-4 x max of the plain sums and
    within 4x their distance from float64, bitwise on a rerun; K5's g_z pass
    (train_gz_tf32_kernel) against its plain version (g_z within 2e-4 x
    max where both route alike: off the route g_z = -acc * a - b) and
    bitwise on a rerun; one launch of each."""
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
    assert launch_counts["conv3x3_smallcin"] == 1
    plain = conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    exact = conv2d_bn_relu_fpool_plain(x.double(), w.double(), scale.double(), bias.double(), pf)
    _f64_gate(f"K2 f32 {b}x{cin}x{f}x{t}->{cout} pf {pf}", got, plain, exact)
    _close(got, plain, torch.float32)
    assert torch.equal(pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf), got)
    assert torch.equal(pool.conv2d_windows_bn_relu_fpool(x, w, scale, bias, pf), got)
    sums = k5.conv_train_stats(x, w, pf)
    assert launch_counts["conv_train_stats"] == 1
    want = k5.conv_train_stats_plain(x, w)
    _f64_gate(f"K5 F1 f32 {b}x{cin}x{f}x{t}->{cout} pf {pf}", sums, want,
              k5.conv_train_stats_plain(x.double(), w.double()))
    _close(sums, want, torch.float32)
    assert torch.equal(k5.conv_train_stats(x, w, pf), sums)
    g = torch.randn(b, cout, f // pf, t, generator=gen, device="cuda")
    a, c = 1e-3 * torch.randn(cout, generator=gen, device="cuda"), 1e-3 * torch.randn(
        cout, generator=gen, device="cuda")
    args = (x, w, g, scale, bias, a, c, pf)
    gz, gz_sums = k5.conv_train_gz(*args)
    assert launch_counts["conv_train_gz"] == 1
    want_gz = k5.conv_train_gz_plain(*args)[0]
    # near-ties of real-valued rows may route apart: compare off the route
    off = (gz - want_gz).abs() <= 2e-4 * want_gz.abs().max()
    assert float(off.float().mean()) > 0.99
    for u, v in zip(k5.conv_train_gz(*args), (gz, gz_sums)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("bits", NAN_BITS)
def test_smallcin_tf32_keeps_nans(gen, bits):
    """A NaN operand (float('nan') or the card's 0x7fffffff) in x (batch 0,
    and batch 1 at a window's last row) comes out of float32 K2 NaN exactly
    where the plain version's does, and makes K5's F1 sums NaN in every
    channel, as the plain sums are."""
    b, cin, f, t, cout, pf = 2, 8, 16, 300, 80, 4
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    x = _put_nan(_put_nan(x, (0, 1, 5, 100), bits), (1, cin - 1, 11, 257), bits)
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
    want = conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    nan = torch.isnan(want)
    assert bool(nan[0].any()) and bool(nan[1].any()) and not bool(nan.all())
    assert torch.equal(torch.isnan(got), nan)
    _close(got.masked_fill(nan, 0), want.masked_fill(nan, 0), torch.float32)
    sums, want = k5.conv_train_stats(x, w, pf), k5.conv_train_stats_plain(x, w)
    assert bool(torch.isnan(want).all()) and torch.equal(torch.isnan(sums), torch.isnan(want))


def test_smallcin_tf32_equals_k10b_at_stage_1(gen):
    """At the flagship's stage 1 (B 2, Cin 8, F 256, T 4800, Cout 192, pf 8)
    on random float32 inputs, K2's float32 output (the float smallcin tile)
    equals K10b's (the float block tile) bit for bit: one K walk."""
    b, cin, f, t, cout, pf = 2, 8, 256, 4800, 192, 8
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    assert torch.equal(pool.conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf),
                       pool.conv2d_windows_bn_relu_fpool(x, w, scale, bias, pf))


def test_conv_tile_f1_f2_bitwise_at_stage_2(gen):
    """At the flagship's stage 2 (B 2, C 192, F 32, T 4800, pf 8) on random
    bf16 inputs, K3's pooled output equals max_r relu(pre * scale + bias)
    from K9 F1's pre bit for bit (the affine as one fma: the float64 product
    of two floats is exact). Integer-grid inputs would hide a broken F1 / F2
    identity: there every order of summation gives the same sums."""
    b, c, f, t, cout, pf = 2, 192, 32, 4800, 192, 8
    h = torch.randn(b, c, f, t, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(3, 3, c, cout, generator=gen, device="cuda") / (9 * c) ** 0.5).to(
        torch.bfloat16)
    _, pre = k9.ct_train_stats(h, w, pf)
    scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    out = pool.conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf)
    y = (pre.double() * scale.double()[:, None, None] + bias.double()[:, None, None]).float()
    want = torch.nn.functional.max_pool2d(torch.relu(y), (pf, 1)).to(torch.bfloat16)
    assert torch.equal(out, want)


# the float32 block tile (split TF32): (b, cin, f, t, cout, pf), several blocks
# in every grid dimension (T tiles of 64 frames, Cout tiles of 64 channels, row
# blocks) with ragged T, Cout and Cin chunk tails: K3 at Cin 24 / 200 (a
# ragged last chunk past 8 channels' multiples is K10b's), K10b at Cin 8 and
# 12 (stage 1's one chunk; a ragged second chunk), pf 1-8, T % 4 != 0 (4-byte
# staging) and T % 4 == 0 (16-byte)
TF32_TILE_CASES = [("conv3x3_widecin", (2, 24, 24, 300, 80, 8)),
                   ("conv3x3_widecin", (1, 200, 12, 257, 136, 4)),
                   ("conv3x3_widecin", (2, 16, 10, 129, 72, 5)),
                   ("conv3x3_windows", (2, 8, 16, 300, 80, 8)),
                   ("conv3x3_windows", (2, 12, 8, 193, 100, 2)),
                   ("conv3x3_windows", (1, 12, 12, 65, 64, 3)),
                   ("conv3x3_windows", (1, 20, 6, 130, 200, 1))]
TF32_TILE_FNS = {"conv3x3_widecin": pool.conv2d_widecin_bn_relu_fpool,
                 "conv3x3_windows": pool.conv2d_windows_bn_relu_fpool}


@pytest.mark.parametrize("name,case", TF32_TILE_CASES)
def test_conv_tile_tf32(gen, name, case):
    """Float32 K3 / K10b (conv3x3_tf32_kernel) and, where Cin % 8 == 0, K9's
    F1 (ct_stats_tf32_kernel) against their plain versions: within 4x the
    float32 plain version's distance from float64, within 2e-4 x max of it,
    one launch each, bitwise on a rerun; K9's F2 (K3's kernel) equals
    max_r relu(fma(pre, scale, bias)) from F1's pre bit for bit."""
    b, cin, f, t, cout, pf = case
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    fn = TF32_TILE_FNS[name]
    got = fn(x, w, scale, bias, pf)
    assert launch_counts[name] == 1
    plain = conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    exact = conv2d_bn_relu_fpool_plain(x.double(), w.double(), scale.double(), bias.double(), pf)
    _f64_gate(f"{name} {case}", got, plain, exact)
    _close(got, plain, torch.float32)
    assert torch.equal(fn(x, w, scale, bias, pf), got)
    if cin % 8:
        return
    sums, pre = k9.ct_train_stats(x, w, pf)
    assert launch_counts["ct_train_stats"] == 1
    want_sums, want_pre = k9.ct_train_stats_plain(x, w)
    _f64_gate(f"ct_train_stats pre {case}", pre, want_pre, k9.ct_train_stats_plain(
        x.double(), w.double())[1])
    _close(sums, want_sums, torch.float32)
    rerun = k9.ct_train_stats(x, w, pf)
    assert torch.equal(rerun[0], sums) and torch.equal(rerun[1], pre)
    out = pool.conv2d_widecin_bn_relu_fpool(x, w, scale, bias, pf)
    y = _fma_f32(pre, scale[:, None, None], bias[:, None, None])
    assert torch.equal(out, torch.nn.functional.max_pool2d(torch.relu(y), (pf, 1)))


def test_conv_tile_tf32_f1_f2_bitwise_at_stage_2(gen):
    """test_conv_tile_f1_f2_bitwise_at_stage_2 in float32: at the flagship's
    stage 2 on random inputs K3's pooled output (the split-TF32 tile) equals
    max_r relu(fma(pre, scale, bias)) from K9 F1's pre bit for bit."""
    b, c, f, t, cout, pf = 2, 192, 32, 4800, 192, 8
    h = torch.randn(b, c, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, c, cout, generator=gen, device="cuda") / (9 * c) ** 0.5
    _, pre = k9.ct_train_stats(h, w, pf)
    scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    out = pool.conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf)
    y = _fma_f32(pre, scale[:, None, None], bias[:, None, None])
    assert torch.equal(out, torch.nn.functional.max_pool2d(torch.relu(y), (pf, 1)))


@pytest.mark.parametrize("bits", NAN_BITS)
@pytest.mark.parametrize("name", ["conv3x3_widecin", "conv3x3_windows", "ct_train_stats"])
def test_conv_tile_tf32_keeps_nans(gen, bits, name):
    """A NaN in x (batch 0, and batch 1 at a window's last row) comes out of
    the float32 tile NaN exactly where the plain version's does: K3's and
    K10b's pooled output, K9 F1's pre."""
    cin = 12 if name == "conv3x3_windows" else 16
    b, f, t, cout, pf = 2, 16, 300, 80, 4
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    x = _put_nan(_put_nan(x, (0, 1, 5, 100), bits), (1, cin - 1, 11, 257), bits)
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    if name == "ct_train_stats":
        got, want = k9.ct_train_stats(x, w, pf)[1], k9.ct_train_stats_plain(x, w)[1]
    else:
        got = TF32_TILE_FNS[name](x, w, scale, bias, pf)
        want = conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    assert launch_counts[name] == 1
    nan = torch.isnan(want)
    assert bool(nan[0].any()) and bool(nan[1].any()) and not bool(nan.all())
    assert torch.equal(torch.isnan(got), nan)
    _close(got.masked_fill(nan, 0), want.masked_fill(nan, 0), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ct_train_routes_nothing_past_a_nan(gen, dtype):
    """K9's B1 and g_z on a pre holding NaNs in row 0 and in later rows of
    some pool windows: a window that holds a NaN routes nothing (JAX's
    _route_group), as the plain version: S_g with g = 1 counts the routed
    windows exactly, S_gx is NaN in exactly the channels with a NaN, and g_z
    is NaN where the plain version's is and within tolerance elsewhere."""
    b, cout, f, t, pf = 2, 72, 16, 300, 8
    pre = torch.randn(b, cout, f, t, generator=gen, device="cuda")
    for at in ((0, 0, 0, 3), (0, 1, 5, 7), (1, 70, 15, 299), (1, 3, 9, 100), (0, 3, 8, 100)):
        pre[at] = float("nan")
    g = torch.randn(b, cout, f // pf, t, generator=gen, device="cuda").to(dtype)
    cols = torch.stack([1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda"),
                        0.2 * torch.randn(cout, generator=gen, device="cuda"),
                        0.1 * torch.randn(cout, generator=gen, device="cuda"),
                        1.0 + 0.1 * torch.rand(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda"),
                        1e-3 * torch.randn(cout, generator=gen, device="cuda")])
    ones = torch.ones_like(g)
    got, want = k9.ct_sel_stats(pre, ones, cols, pf), k9.ct_sel_stats_plain(pre, ones, cols, pf)
    assert torch.equal(got[:cout], want[:cout])   # whole counts, exact in float
    nan = torch.isnan(want[cout:])
    assert int(nan.sum()) == 4 and torch.equal(torch.isnan(got[cout:]), nan)
    _close(got[cout:].masked_fill(nan, 0), want[cout:].masked_fill(nan, 0), torch.float32)
    gz, gz_want = k9.ct_gz(pre, g, cols, pf), k9.ct_gz_plain(pre, g, cols, pf)
    nan = torch.isnan(gz_want)
    assert int(nan.sum()) == 5 and torch.equal(torch.isnan(gz), nan)
    _close(gz.masked_fill(nan, 0), gz_want.masked_fill(nan, 0), dtype)


def test_ct_frontend_raises_where_the_kernels_cannot_run(gen):
    """frontend_impl='ct' on a CUDA tensor takes K5 + K9 or raises: stages
    with biased convs do not fall back to the plain stages."""
    from seld_tpu_torch.models.blocks import ConvTCBlock

    block = ConvTCBlock("DQ", 8, 16, [8, 16], 3, [[2, 1], [2, 1]], "CNN", [1], "fibonacci", 16,
                        16, 3, [16, 16], 3, use_bias=True, batch_norm="BN",
                        attention_impl="full", frontend_impl="ct", device="cuda",
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 8, 8, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="K5/K9 conditions"):
        block(x, train=True, generator=gen)
    assert all(v == 0 for v in launch_counts.values())


# ---- K7 (Hamilton matmul) and K8 (int8 matmul): the predict path ------------

from seld_tpu_torch.ops.kernels import qmatmul as k7   # noqa: E402
from seld_tpu_torch.ops.kernels import quant as k8     # noqa: E402

# (M, n, cin_c, cout_c, linear_table): 17 row tiles with a ragged tail (9 of
# bf16's 128-row tiles); widths 48 / 80 and 64 / 48 cross the 64-wide tiles and
# the Hamilton blocks; then for the bf16 kernel K = 20 (K % 8 != 0: 2-byte x
# loads), K = 24 (K % 16 != 0: a zero-filled k16 step; cout_c 16: 16-byte weight
# loads), the flagship's widths and the Q configs' cin_c 96, both tables
K7_CASES = [(1037, 4, 12, 20, False), (1037, 8, 6, 10, False), (1037, 8, 6, 10, True),
            (300, 8, 8, 6, True), (1029, 4, 5, 16, False), (513, 8, 3, 16, True),
            (2001, 8, 48, 48, False), (777, 4, 96, 24, True)]


def ulps_apart(got, want, dtype):
    """Elements of got further than one ulp of dtype (at want) from want."""
    torch.cuda.synchronize()
    bits = 23 if dtype == torch.float32 else 7
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want.float()), e - 1 - bits)
    return int(((got.float() - want.float()).abs() > ulp).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,cin_c,cout_c,linear_table", K7_CASES)
def test_hamilton_matmul_kernel(gen, dtype, m, n, cin_c, cout_c, linear_table):
    x = torch.randn(m, n * cin_c, generator=gen, device="cuda").to(dtype)
    comps = torch.randn(n, cin_c, cout_c, generator=gen, device="cuda").to(dtype)
    bias = torch.randn(n * cout_c, generator=gen, device="cuda").to(dtype)
    for b in (bias, None):
        reset_launch_counts()
        got = k7.hamilton_matmul(x, comps, b, n, linear_table)
        assert launch_counts["hamilton_matmul"] == 1
        _close(got, k7.hamilton_matmul_plain(x, comps, b, n, linear_table), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,cin_c,cout_c,linear_table", K7_CASES[:3])
def test_hamilton_matmul_function_gradients(gen, dtype, m, n, cin_c, cout_c, linear_table):
    """The autograd Function (K7 forward, K7 on the conjugate for dx) against
    autograd of the plain version: out, dx, dcomps, db."""
    x = torch.randn(m, n * cin_c, generator=gen, device="cuda").to(dtype)
    comps = torch.randn(n, cin_c, cout_c, generator=gen, device="cuda").to(dtype)
    bias = torch.randn(n * cout_c, generator=gen, device="cuda").to(dtype)
    g = torch.randn(m, n * cout_c, generator=gen, device="cuda").to(dtype)
    results = []
    for fn in (k7._HamiltonMatmulFn.apply, k7.hamilton_matmul_plain):
        leaves = [v.clone().requires_grad_() for v in (x, comps, bias)]
        out = fn(*leaves, n, linear_table)
        (out.float() * g.float()).sum().backward()
        results.append((out, *(v.grad for v in leaves)))
    assert launch_counts["hamilton_matmul"] == 2   # forward and dx
    for got, want in zip(*results):
        _close(got, want, dtype)


def _misaligned(a):
    """a's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary (K7 then stages that operand element by element)."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = flat[1:].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("m,n,cin_c,cout_c,linear_table", K7_CASES)
def test_hamilton_matmul_tf32(gen, m, n, cin_c, cout_c, linear_table):
    """K7 in float32 (hamilton_tf32_kernel), with bias and without, x and
    comps also unaligned (element-by-element staging; cout_c 10 and 6 force
    it for the weight anyway): within 2e-4 x max of the plain version and
    within 4x its distance from float64, bitwise on a rerun; dx through the
    autograd Function (K7 on the conjugate) within 4x the plain autograd's
    distance from float64."""
    x = torch.randn(m, n * cin_c, generator=gen, device="cuda")
    comps = torch.randn(n, cin_c, cout_c, generator=gen, device="cuda") / cin_c ** 0.5
    bias = torch.randn(n * cout_c, generator=gen, device="cuda")
    for xx, cc in ((x, comps), (_misaligned(x), _misaligned(comps))):
        for b in (bias, None):
            reset_launch_counts()
            got = k7.hamilton_matmul(xx, cc, b, n, linear_table)
            assert launch_counts["hamilton_matmul"] == 1
            exact = k7.hamilton_matmul_plain(xx.double(), cc.double(),
                                             None if b is None else b.double(), n, linear_table)
            want = k7.hamilton_matmul_plain(xx, cc, b, n, linear_table)
            _f64_gate(f"K7 {m}x{n}x{cin_c}x{cout_c} {linear_table} bias {b is not None}",
                      got, want, exact)
            _close(got, want, torch.float32)
            assert torch.equal(k7.hamilton_matmul(xx, cc, b, n, linear_table), got)
    g = torch.randn(m, n * cout_c, generator=gen, device="cuda")
    dx = []
    for fn, dt in ((k7._HamiltonMatmulFn.apply, torch.float32),
                   (k7.hamilton_matmul_plain, torch.float32),
                   (k7.hamilton_matmul_plain, torch.float64)):
        leaf = x.detach().to(dt).clone().requires_grad_()
        (fn(leaf, comps.to(dt), bias.to(dt), n, linear_table) * g.to(dt)).sum().backward()
        dx.append(leaf.grad)
    _f64_gate(f"K7 dx {m}x{n}x{cin_c}x{cout_c} {linear_table}", *dx)


@pytest.mark.parametrize("bits", NAN_BITS)
def test_hamilton_matmul_tf32_keeps_nans(gen, bits):
    """A NaN in x or in comps of K7's float32 kernel comes out NaN exactly
    where the plain version's does (x's row; the columns of every block the
    component takes part in, zero corner included for x)."""
    m, n, cin_c, cout_c = 300, 8, 48, 48
    x = _put_nan(torch.randn(m, n * cin_c, generator=gen, device="cuda"), (5, 17), bits)
    comps = _put_nan(torch.randn(n, cin_c, cout_c, generator=gen, device="cuda"), (2, 7, 30), bits)
    for table in (False, True):
        got = k7.hamilton_matmul(x, comps, None, n, table)
        want = k7.hamilton_matmul_plain(x, comps, None, n, table)
        assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
        assert torch.equal(torch.isnan(got), torch.isnan(want))


# (M, Cin, Cout): M below one block (20), ragged against both row tiles, the
# flagship's 4800 (a clip: 64-row blocks) and 9600 (batch 2), and under 2816
# at Cout 384 (32-row blocks by the tile rule); Cin 30 and 48 (k padded to 32
# and 64: a half k chunk; 30 * 4 bytes not a 16-byte row, x quantized element
# by element), 384, and 3200 (32-row blocks: 64 rows do not fit shared
# memory); Cout 7 (odd: element by element stores), 80 and 384 (three
# 128-column passes)
K8_CASES = [(1037, 48, 80), (300, 384, 384), (129, 30, 7), (20, 30, 80), (20, 384, 7),
            (4800, 384, 384), (9600, 384, 384), (9600, 48, 7), (4800, 30, 384),
            (300, 3200, 80)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,cin,cout", K8_CASES)
def test_int8_matmul_kernel(gen, dtype, m, cin, cout, monkeypatch):
    """K8 against its plain version at the wrapper's row tile, then with
    64- and 32-row blocks forced where they fit: no element beyond one ulp
    (the same arithmetic with the int32 sum exact in any order; the plain
    epilogue rounds through float64, which may differ from one fma's
    rounding at a tie), the tiles bit-equal, a zero row giving the bias."""
    x = torch.randn(m, cin, generator=gen, device="cuda")
    x = (x * torch.rand(m, 1, generator=gen, device="cuda") * 10).to(dtype)
    x[5] = 0
    w_q, w_s = k8.quantize_weight_per_channel(
        torch.randn(cin, cout, generator=gen, device="cuda"))
    bias = torch.randn(cout, generator=gen, device="cuda").to(dtype)
    want = k8.int8_matmul_plain(x, w_q, w_s, bias)
    first = None
    variants = [k8.ROW_TILES] + [(bm,) for bm in k8.ROW_TILES
                                 if k8.smem_bytes(bm, cin) <= k8.SMEM_BYTES]
    for i, tiles in enumerate(variants):
        monkeypatch.setattr(k8, "ROW_TILES", tiles)
        got = k8.int8_matmul(x, w_q, w_s, bias)
        assert launch_counts["int8_matmul"] == i + 1
        assert got.dtype == dtype and got.shape == want.shape
        assert ulps_apart(got, want, dtype) == 0, tiles
        assert torch.equal(got[5].float(), bias.float())
        first = got if first is None else first
        assert torch.equal(got, first), tiles


def test_int8_matmul_bias_as_it_comes(gen):
    """K8 reads the bias in float32, in bf16 (as the layers pass it) or none."""
    x = torch.randn(1037, 48, generator=gen, device="cuda").to(torch.bfloat16)
    w_q, w_s = k8.quantize_weight_per_channel(torch.randn(48, 80, generator=gen, device="cuda"))
    bias = torch.randn(80, generator=gen, device="cuda")
    for b in (None, bias, bias.to(torch.bfloat16)):
        got = k8.int8_matmul(x, w_q, w_s, b)
        assert ulps_apart(got, k8.int8_matmul_plain(x, w_q, w_s, b), torch.bfloat16) == 0
    assert launch_counts["int8_matmul"] == 3


def test_predict_cli_on_the_card_launches_k7_and_k8(gen, tmp_path):
    """python -m seld_tpu_torch.predict --impl apply on a tiny config, with
    qconv_impl 'pallas' (K7 on 2 skip + 2 res + 2 heads = 6 launches per
    clip) and 'int8' (K8, the same 6)."""
    import numpy as np

    from seld_tpu_torch import predict

    cfg = tmp_path / "cfg.txt"
    cfg.write_text("--domain=DQ\n--cnn_filters=[8,8,8]\n--input_channels=8\n--G=8\n--U=8\n"
                   "--V=[16,16]\n--fc_layers=[16]\n--D=[2]\n--use_bias_conv=False\n"
                   "--pool_size=[[8,2],[8,2],[2,2]]\n--pool_time=TCN\n--attention_impl=full\n")
    clip = tmp_path / "clip.npy"
    np.save(clip, np.random.default_rng(0).standard_normal((8, 32000)).astype(np.float32))
    for impl, name in (("pallas", "hamilton_matmul"), ("int8", "int8_matmul")):
        reset_launch_counts()
        res = predict.main([f"--TextArgs={cfg}", "--inputs", str(clip), f"--out-dir={tmp_path}",
                            "--impl=apply", f"--qconv_impl={impl}"])
        assert launch_counts[name] == 6 and launch_counts["stft_mag"] == 1
        assert np.isfinite(res[0]["sed"]).all() and res[0]["sed"].shape == (10, 42)


# ---- K2w (wide pack), K10a (im2col), K10b (per-tap windows) -------------------

# (b, cin, f, t, cout, pf): 3 T tiles with a ragged last one, >= 2 Cout tiles
# with a ragged last one, several pool groups, F borders. In bf16 K2w and K10a
# run the GEMM tile (64 channels x 128 frames): T 300 and 257 are three frame
# tiles (257 odd: frame by frame stores), Cout 80 / 136 / 200 / 70 two to four
# channel tiles (70: K10a's weight rows padded to 72); K2w at Cin 5 (kg 16), 8
# and 10 (kg 32), K10a at Cin 3, 12 and 20 (K 27, 108, 180 padded to
# multiples of 8 with zero columns; 27 and 180 end in a short k16 chunk)
FRONTEND_CASES = {
    "conv3x3_smallcin_wide": (pool.conv2d_smallcin_wide_bn_relu_fpool,
                              [(2, 5, 24, 300, 80, 8), (2, 8, 8, 130, 64, 2),
                               (1, 10, 12, 257, 200, 4), (2, 8, 16, 257, 200, 2),
                               (1, 10, 12, 300, 136, 4)]),
    "conv3x3_im2col": (pool.conv2d_im2col_bn_relu_fpool,
                       [(2, 3, 24, 300, 80, 8), (2, 12, 8, 130, 64, 2),
                        (1, 20, 12, 257, 200, 4), (1, 12, 16, 257, 200, 2),
                        (2, 20, 12, 300, 70, 4)]),
    "conv3x3_windows": (pool.conv2d_windows_bn_relu_fpool,
                        [(2, 12, 24, 300, 80, 8), (2, 20, 9, 130, 64, 3),
                         (1, 200, 12, 257, 72, 4)]),
}
PLAIN = {"conv3x3_smallcin_wide": pool.conv2d_smallcin_wide_bn_relu_fpool_plain,
         "conv3x3_im2col": pool.conv2d_im2col_bn_relu_fpool_plain,
         "conv3x3_windows": pool.conv2d_bn_relu_fpool_plain}
# K2w's and K10a's operand builds and their products on the built operands,
# the two public functions each wrapper calls (timed apart by chip_smoke.py)
PRODUCTS = {
    "conv3x3_smallcin_wide": (pool.smallcin_pack, lambda ops, s, b, pf, t, cin:
                              pool.smallcin_wide_product(*ops, s, b, pf, t, cin)),
    "conv3x3_im2col": (pool.im2col_operands, lambda ops, s, b, pf, t, cin:
                       pool.im2col_product(*ops, s, b, pf)),
}
# launches of one call: K10a builds its patches with a kernel of its own first
LAUNCHES = {"conv3x3_smallcin_wide": {"conv3x3_smallcin_wide": 1},
            "conv3x3_im2col": {"im2col_patches": 1, "conv3x3_im2col": 1},
            "conv3x3_windows": {"conv3x3_windows": 1}}


def _launched() -> dict:
    return {k: v for k, v in launch_counts.items() if v}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,case", [(n, c) for n, (_, cs) in FRONTEND_CASES.items()
                                       for c in cs])
def test_frontend_variant_kernel(gen, dtype, name, case):
    """K2w, K10a and K10b against their plain versions (K10b: Cin 200 ends in
    a ragged chunk of 8, pf 3 an odd pool window), with their launches (K10a
    its patch kernel and its product); K2w's and K10a's products on their
    built operands bit for bit the wrappers; then a CUDA tensor they cannot
    take raises and launches nothing."""
    b, cin, f, t, cout, pf = case
    fn = FRONTEND_CASES[name][0]
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = fn(x, w, scale, bias, pf)
    assert _launched() == LAUNCHES[name] and got.shape == (b, cout, f // pf, t)
    _close(got, PLAIN[name](x, w, scale, bias, pf), dtype)
    if name in PRODUCTS:   # the wrapper is its operand build, then its product
        build, product = PRODUCTS[name]
        operands = build(x, w)
        reset_launch_counts()
        assert torch.equal(product(operands, scale, bias, pf, t, cin), got)
        assert _launched() == {name: 1}
    reset_launch_counts()
    with pytest.raises(TypeError):    # no float64 kernel
        fn(x.double(), w.double(), scale, bias, pf)
    with pytest.raises(TypeError):    # scale and bias are float32
        fn(x, w, scale.half(), bias, pf)
    with pytest.raises(ValueError):   # mixed devices
        fn(x, w.cpu(), scale, bias, pf)
    if name == "conv3x3_smallcin_wide":
        x11 = torch.zeros(1, 11, 8, 20, device="cuda", dtype=dtype)
        with pytest.raises(ValueError):   # 3 * Cin > 32: beyond the wide pack
            fn(x11, torch.zeros(3, 3, 11, 8, device="cuda", dtype=dtype), scale[:8], bias[:8], 2)
    assert not any(launch_counts.values())


# ---- float32 K2w and K10a on the split-TF32 tile (pool_gemm_tf32.cuh) ----------

# (b, cin, f, t, cout, pf): K2w at Cin 5 (rows 16 of kg 16), 8 (24 of 32) and 10
# (32 of 32); K10a at Cin 3 (K 27: 4-byte copies, one ragged chunk), 20 (K 180)
# and 192 (K 1728, stage 2's depth, 54 chunks); frame tiles ragged (300, 257),
# Cout tiles ragged (80, 200, 136), odd T (frame by frame stores)
TF32_FRONTEND_CASES = [
    ("conv3x3_smallcin_wide", (2, 5, 24, 300, 80, 8)),
    ("conv3x3_smallcin_wide", (2, 8, 16, 257, 200, 2)),
    ("conv3x3_smallcin_wide", (1, 10, 12, 300, 136, 4)),
    ("conv3x3_im2col", (2, 3, 24, 300, 80, 8)),
    ("conv3x3_im2col", (1, 20, 12, 257, 200, 4)),
    ("conv3x3_im2col", (1, 192, 8, 300, 136, 2)),
]


@pytest.mark.parametrize("name,case", TF32_FRONTEND_CASES)
def test_frontend_tf32(gen, name, case):
    """Float32 K2w (smallcin_wide_tf32_kernel) and K10a (im2col_tf32_kernel)
    against their plain versions in float32 (TF32 off): within 4x the
    plain version's distance from float64 and within 2e-4 x max of it,
    one launch, and bitwise on a rerun."""
    b, cin, f, t, cout, pf = case
    fn = FRONTEND_CASES[name][0]
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = fn(x, w, scale, bias, pf)
    assert launch_counts[name] == 1
    plain = PLAIN[name](x, w, scale, bias, pf)
    exact = PLAIN[name](x.double(), w.double(), scale.double(), bias.double(), pf)
    _f64_gate(f"{name} {case}", got, plain, exact)
    _close(got, plain, torch.float32)
    assert torch.equal(fn(x, w, scale, bias, pf), got)


@pytest.mark.parametrize("cin", [2, 7, 8])
def test_smallcin_wide_tf32_never_reads_the_zero_rows(gen, cin):
    """K2w's float32 product walks only the first 3 Cin rounded up to 8 rows
    of each kg group (``conv2d_pool.smallcin_rows``: 8 of 16 at Cin 2, 24 of
    32 at Cin 7 and 8): on a pack whose rows past them hold NaN it gives the
    clean pack's bits."""
    b, f, t, cout, pf = 2, 8, 257, 80, 4
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    p0, wk = pool.smallcin_pack(x, w)
    rows = pool.smallcin_rows(cin)
    assert rows < p0.shape[2]
    poisoned = p0.clone()
    poisoned[:, :, rows:] = float("nan")
    clean = pool.smallcin_wide_product(p0, wk, scale, bias, pf, t, cin)
    assert bool(torch.isfinite(clean).all())
    assert torch.equal(pool.smallcin_wide_product(poisoned, wk, scale, bias, pf, t, cin), clean)


# the serving stage's kernels: (wrapper, Cin) of K2, K3, K10b, K2w and K10a
NAN_STAGE_KERNELS = {
    "conv3x3_smallcin": (pool.conv2d_smallcin_bn_relu_fpool, 8),
    "conv3x3_widecin": (pool.conv2d_widecin_bn_relu_fpool, 16),
    "conv3x3_windows": (pool.conv2d_windows_bn_relu_fpool, 12),
    "conv3x3_smallcin_wide": (pool.conv2d_smallcin_wide_bn_relu_fpool, 8),
    "conv3x3_im2col": (pool.conv2d_im2col_bn_relu_fpool, 12),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(NAN_STAGE_KERNELS))
def test_conv_pool_keeps_nans(gen, dtype, name):
    """A NaN in x (batch 0, and batch 1 at a window's last row) comes out of
    each conv-pool kernel NaN exactly where its plain version's does (ReLU
    and the pool keep a NaN, as jnp.maximum and jnp.max do), and every other
    output within the dtype's tolerance of it."""
    fn, cin = NAN_STAGE_KERNELS[name]
    b, f, t, cout, pf = 2, 16, 300, 80, 4
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda")
    x[0, 1, 5, 100] = float("nan")
    x[1, cin - 1, 11, 257] = float("nan")
    x = x.to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cout, generator=gen, device="cuda")
    got = fn(x, w, scale, bias, pf)
    assert launch_counts[name] == 1
    want = pool.conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
    nan = torch.isnan(want)
    assert bool(nan[0].any()) and bool(nan[1].any()) and not bool(nan.all())
    assert torch.equal(torch.isnan(got), nan)
    _close(got.masked_fill(nan, 0), want.masked_fill(nan, 0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,cin,f,t,k_align", [(2, 3, 5, 45, 8), (1, 8, 4, 257, 8),
                                               (2, 12, 3, 70, 8), (1, 20, 6, 33, 1),
                                               (1, 130, 3, 65, 8), (2, 192, 2, 40, 8)])
def test_im2col_patch_kernel(gen, dtype, b, cin, f, t, k_align):
    """K10a's patch build (``conv2d_pool.im2col``): bit for bit the torch
    build's patches and zero columns, F and T borders, T ragged against its
    32-frame tiles, Cin ragged against its 64-channel chunks (130) and not
    a multiple of the 16-byte vector (3, 12, 20: element by element)."""
    x = torch.randn(b, cin, f, t, generator=gen, device="cuda").to(dtype)
    got = pool.im2col(x, k_align)
    assert _launched() == {"im2col_patches": 1}
    assert torch.equal(got, pool.im2col_patches(x, k_align))


@pytest.mark.parametrize("cin,impl,name", [(8, "wide", "conv3x3_smallcin_wide"),
                                           (10, "thin", "conv3x3_smallcin_wide"),
                                           (12, "thin", "conv3x3_windows")])
def test_fused_infer_routes_stage_one(gen, cin, impl, name):
    """fused_infer on an R-domain model: stage 1 on the routed kernel, stages
    2-3 (Cin 16) on K3, within 1e-4 of the float32 plain model(x) (V 128:
    the flash kernel's head dim 16)."""
    from seld_tpu_torch.models.fused_infer import fused_infer
    from seld_tpu_torch.models.seld import SELDModel

    model = SELDModel(freq_dim=64, input_channels=cin, domain="R", cnn_filters=(16, 16, 16),
                      pool_size=((4, 2), (4, 2), (2, 2)), D=(3,), G=16, U=16, V=(128, 128),
                      fc_layers=(16,), attention_impl="full", device="cuda",
                      generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(2, cin, 64, 200, generator=gen, device="cuda")
    with torch.no_grad():
        want = model(x)
    reset_launch_counts()
    got = fused_infer(model, x, smallcin_impl=impl)
    assert launch_counts[name] == 1 and launch_counts["conv3x3_widecin"] == 2
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-4)


# ---- the reduction hook of data parallelism at one rank, and the .seldpak reader ----

@pytest.fixture
def one_rank(gen):
    """A one-rank gloo group in this process and its reduction hook
    (``parallel/cross_rank.py``): at world size 1 an all-reduce is the
    identity, so K5 and K9 must give the bits they give without the hook."""
    import datetime
    import socket

    import torch.distributed as dist

    from seld_tpu_torch.parallel import CrossRank

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield CrossRank()
    finally:
        dist.destroy_process_group()


def _op_grads(fn, inputs, g, **kw):
    """(outputs..., grads of the differentiable inputs) of one forward and
    backward of ``fn``."""
    first, *rest = inputs
    leaves = [v.clone().requires_grad_() for v in rest]
    out, mean, var = fn(first, *leaves, **kw)
    (out.float() * g.float()).sum().backward()
    return [out, mean, var, *(v.grad for v in leaves)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_train_op_with_the_hook_at_one_rank(one_rank, gen, dtype):
    """K5 with the hook at world size 1: out, mean, var, dW, dgamma and dbeta
    bit for bit as without it; F1's and B1's sums through the hook once each."""
    b, cin, f, t, cout, pf = K5_SHAPES[0]
    x, w, gamma, beta = k5_inputs(gen, b, cin, f, t, cout, dtype)
    x = x + 0.25 * torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, f // pf, t, cout, generator=gen, device="cuda").to(dtype)
    want = _op_grads(lambda *a: k5.conv2d_bn_relu_fpool_train(*a, pf), (x, w, gamma, beta), g)
    reset_launch_counts()
    got = _op_grads(lambda *a: k5.conv2d_bn_relu_fpool_train(*a, pf, cross_rank=one_rank),
                    (x, w, gamma, beta), g)
    assert {n: launch_counts[n] for n in k5_launches(dtype)} == k5_launches(dtype)
    assert dict(one_rank.counts) == {"K5 F1": 1, "K5 B1": 1}
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_ct_train_with_the_hook_at_one_rank(one_rank, gen, dtype):
    """K9 with the hook at world size 1: out, mean, var, dh, dW, dgamma and
    dbeta bit for bit as without it; F1's and B1's sums through the hook once
    each."""
    b, c, f, t, cout, pf = K9_SHAPES[0]
    h, w, gamma, beta = k9_inputs(gen, b, c, f, t, cout, dtype)
    h = h + 0.25 * torch.randn(h.shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, cout, f // pf, t, generator=gen, device="cuda").to(dtype)
    inputs = (h, w, gamma, beta)

    def run(**kw):
        hr = h.clone().requires_grad_()
        out = _op_grads(lambda _, *a: k9.conv2d_ct_bn_relu_fpool_train(hr, *a, pf, **kw),
                        inputs, g)
        return out + [hr.grad]

    want = run()
    reset_launch_counts()
    got = run(cross_rank=one_rank)
    assert all(launch_counts[n] == 1 for n in ("ct_train_stats", "ct_train_sel_stats",
                                               "ct_train_gz", "ct_train_dw", "ct_train_dx"))
    assert dict(one_rank.counts) == {"K9 F1": 1, "K9 B1": 1}
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_seldpak_gather_on_the_cards_host(gen, tmp_path):
    """The .seldpak reader built and run on the card's host: the C++ gather
    equals its numpy plain version on shuffled batches of one-minute clips'
    feature rows (8 x 256 x 480 a row here), and the batch reaches the card."""
    import numpy as np

    from seld_tpu_torch.data.native import PakReader, write_pak

    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 8, 256, 480)).astype(np.float32)
    y = rng.standard_normal((24, 60, 168)).astype(np.float32)
    path = str(tmp_path / "d.seldpak")
    write_pak(path, [x, y])
    with PakReader(path) as reader:
        for _ in range(5):
            idx = rng.permutation(24)[:8]
            for i in (0, 1):
                got = reader.gather(i, idx)
                assert np.array_equal(got, reader.gather_plain(i, idx))
                assert np.array_equal(got, [x, y][i][idx])
            on_card = torch.from_numpy(reader.gather(0, idx)).to("cuda")
            assert torch.equal(on_card.cpu(), torch.from_numpy(x[idx]))
