"""Fused CNN-frontend stage (K2, K2w, K3, K10a, K10b): kernel wrappers and
plain versions.

``maxpool_f(relu(conv3x3(x, w) * scale + bias))`` with zero padding 1 and a
VALID frequency max-pool of ``pool_f`` rows (time is not pooled), writing only
the pooled output, in the NCHW layout (H = frequency, W = time) instead of
the TPU's CT/CTH layouts. Counterparts of ``seld_tpu/ops/pallas/conv2d_pool.py``:

- K2 ``conv2d_smallcin_thin_bn_relu_fpool`` (Cin <= 8):
  :func:`conv2d_smallcin_bn_relu_fpool`, and K3
  ``conv2d_widecin_ct_bn_relu_fpool`` (Cin % 8 == 0):
  :func:`conv2d_widecin_bn_relu_fpool`, both ``csrc/conv3x3_bn_relu_fpool.cu``
  (K2 in bfloat16 on the tensor cores with K = 9 taps x 8 channels, padded to
  80, in float32 in split TF32 on the float smallcin tile
  (``csrc/conv3x3_smallcin_tf32.cuh``, K = 72 as nine k8 steps, the block
  tile's K walk); K3 on the block tile, bfloat16 on ``mma.sync``
  (``csrc/conv3x3_tc.cuh``), float32 in split TF32
  (``csrc/conv3x3_tf32.cuh``));
- K2w ``conv2d_smallcin_bn_relu_fpool`` (3 * Cin <= 32, the wide pack):
  :func:`conv2d_smallcin_wide_bn_relu_fpool`, ``csrc/conv3x3_smallcin_wide.cu``;
- K10a ``conv2d_im2col_bn_relu_fpool`` (any Cin, materialized patches):
  :func:`conv2d_im2col_bn_relu_fpool`, ``csrc/conv3x3_im2col.cu``
  (K2w and K10a in bfloat16 on the GEMM tile of ``csrc/pool_gemm_tc.cuh``,
  in float32 on its split-TF32 counterpart ``csrc/pool_gemm_tf32.cuh``);
- K10b ``conv2d_bn_relu_fpool`` (any Cin, per-tap windows):
  :func:`conv2d_windows_bn_relu_fpool`, ``csrc/conv3x3_windows.cu`` (K3's
  kernel under its own entry and count).

:func:`conv2d_bn_relu_fpool` is the serving stage's dispatcher; it picks one
of four kernels per stage by :func:`frontend_stage_kernel`, as
``seld_tpu/models/fused_infer.py::_trunk_frontend`` does:

- ``smallcin_impl == 'thin'`` and Cin <= 8: K2;
- else 3 * Cin <= 32: K2w;
- else Cin % 8 == 0: K3;
- else: K10b (where the JAX package runs an XLA conv; its module docstring
  names the windows kernel for such stages).

K10a is reached from the per-stage profiler only
(``python -m seld_tpu_torch.profile_stages``), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seld_tpu_torch import _build
from seld_tpu_torch.ops.kernels import (
    dtype_code, launch_counts, on_cuda, require_contiguous, stream_handle,
)

MAX_POOL_F = 48  # cap of the SIMT smallcin halo staging's rows; K9's pool limit
SMALLCIN_MAX_CIN = 10   # K2's kernel: Cin <= 8, and 9-10 (3 * Cin <= 32) for K5's forward
BLOCK_T = 128           # frames per tile of K2's and K5's kernels (kBT, kScfT)
BLOCK_CO = 64           # output channels per kernel tile (kBCO)
SMEM_BYTES = 232_448    # shared memory one block may use on the H100
TC_BLOCK_T = 64         # frames per block of the block tiles (kTbT in conv3x3_tc.cuh)
TC_SLOTS = 4            # conv rows per pass of the block tile (kTbSlots)
SMALLCIN_IMPLS = ("thin", "wide")
GRID_Z_MAX = 65535


def _check(x, w, scale, bias, pool_f) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Cin, F, T), got {tuple(x.shape)}")
    cin = x.shape[1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
    if pool_f < 1 or x.shape[2] % pool_f:
        raise ValueError(f"F={x.shape[2]} must divide into pool_f={pool_f} rows")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _epilogue(y: torch.Tensor, scale, bias, pool_f: int, dtype) -> torch.Tensor:
    """relu(y * scale + bias) max-pooled over pool_f rows, y (B, Cout, F, T)
    in the accumulation dtype; the result in ``dtype``."""
    adt = y.dtype
    y = y * scale.to(adt)[:, None, None] + bias.to(adt)[:, None, None]
    return F.max_pool2d(torch.relu(y), (pool_f, 1)).to(dtype)


def conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f: int) -> torch.Tensor:
    """Plain version: conv in x's dtype, affine + ReLU + pool in float32
    (float64 for float64 input), result in x's dtype."""
    _check(x, w, scale, bias, pool_f)
    y = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return _epilogue(y.to(_acc_dtype(x)), scale, bias, pool_f, x.dtype)


def frontend_stage_kernel(cin: int, smallcin_impl: str = "thin") -> str:
    """Launch-count name of the kernel a serving stage with ``cin`` input
    channels runs (``seld_tpu/models/fused_infer.py:276-303``)."""
    if smallcin_impl not in SMALLCIN_IMPLS:
        raise ValueError(f"smallcin_impl {smallcin_impl!r} not in {SMALLCIN_IMPLS}")
    if cin < 1:
        raise ValueError(f"Cin must be >= 1, got {cin}")
    if smallcin_impl == "thin" and cin <= 8:
        return "conv3x3_smallcin"
    if 3 * cin <= 32:
        return "conv3x3_smallcin_wide"
    if cin % 8 == 0:
        return "conv3x3_widecin"
    return "conv3x3_windows"


def tc_block_rows(pool_f: int) -> int:
    """Conv rows one block of the block tiles takes (``tb_block_rows``):
    one pool window, or 4 rows (4 / pool_f windows) where pool_f is 1 or 2,
    so that a pass fills its 4 row slots."""
    return TC_SLOTS if pool_f <= 2 else pool_f


def _check_launch(x, w, scale, bias, out_shape) -> int:
    """Check the operands of a CUDA launch; returns x's dtype code."""
    require_contiguous(x=x, w=w, scale=scale, bias=bias)
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    if out_shape[0] * out_shape[2] > GRID_Z_MAX:
        raise ValueError("B * F / pool_f exceeds the grid's z range")
    return dtype_code(x)


def _launch(name, x, w, scale, bias, pool_f, out_shape, *sizes, chunk=None) -> torch.Tensor:
    """Check the operands of a CUDA launch, launch ``seld_<name>`` with
    (x, w, scale, bias, out, *sizes, pool_f[, chunk], dtype, stream) and
    count it."""
    code = _check_launch(x, w, scale, bias, out_shape)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"seld_{name}")
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
             *sizes, pool_f, *(() if chunk is None else (chunk,)), code,
             stream_handle(x.device))
    _build.check(err, f"seld_{name}")
    launch_counts[name] += 1
    return out


def conv2d_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, pool_f: int,
                         smallcin_impl: str = "thin") -> torch.Tensor:
    """x (B, Cin, F, T), w (3, 3, Cin, Cout) in x's dtype, scale/bias (Cout,)
    float32 -> (B, Cout, F/pool_f, T) in x's dtype.

    Runs the kernel :func:`frontend_stage_kernel` picks through its wrapper
    (K2, K2w, K3 or K10b). CPU tensors take the chosen kernel's plain
    version (K2 and K3: :func:`conv2d_bn_relu_fpool_plain`)."""
    _check(x, w, scale, bias, pool_f)
    name = frontend_stage_kernel(x.shape[1], smallcin_impl)
    if name == "conv3x3_smallcin_wide":
        return conv2d_smallcin_wide_bn_relu_fpool(x, w, scale, bias, pool_f)
    if name == "conv3x3_windows":
        return conv2d_windows_bn_relu_fpool(x, w, scale, bias, pool_f)
    if name == "conv3x3_smallcin":
        return conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pool_f)
    return conv2d_widecin_bn_relu_fpool(x, w, scale, bias, pool_f)


def staged_channels(cin: int) -> int:
    """Input channels K2's and K5's kernels stage at once (kCC = 8, or 16 past
    Cin 8, zero-filled past Cin)."""
    return 8 if cin <= 8 else 16


def halo_max_pool_f(cin: int) -> int:
    """The largest pool_f whose pool_f + 2 float halo rows of
    :func:`staged_channels` channels and the 9 x channels x BLOCK_CO float
    weights fit one block's shared memory, capped at MAX_POOL_F: the SIMT
    kernel's rows per staging (``kSimtChunkRows``), which K2's bfloat16
    entry runs at Cin 9-10."""
    cc = staged_channels(cin)
    fixed = 4 * 9 * cc * BLOCK_CO
    return min(MAX_POOL_F, (SMEM_BYTES - fixed) // (4 * cc * (BLOCK_T + 2)) - 2)


TC_SMALLCIN_PAIRS = 4     # channel pairs the bf16 smallcin kernel stages (kScPairs)
TC_SMALLCIN_K = 80        # its weight rows: 9 taps x 8 channels, padded (kScK)
TC_PAIR_WORDS = 168       # staged words per (row, channel pair) (kTcXS)
FLOAT_TILE_ROW_WORDS = BLOCK_T + 8   # the float smallcin tile's staged (row, ci): kScfXS
FLOAT_TILE_A_WORDS = 4 * 9 * 4 * 32  # a weight plane's words per 8-channel chunk (kFtWItems x 4)
FLOAT_TILE_COLS = 4 * BLOCK_CO       # its per-channel columns (kScfCols)


def float_tile_max_pool_f(cin: int) -> int:
    """Rows one halo staging of the float smallcin tile takes
    (``scf_chunk_rows``: K2 and K5's F1, F2 and g_z pass in float32): the
    most whose rows + 2 staged rows of :func:`staged_channels` channels x
    FLOAT_TILE_ROW_WORDS floats fit one block's shared memory beside the
    split weights (hi and lo planes of FLOAT_TILE_A_WORDS words a chunk of
    8 channels) and the columns: 42 at Cin <= 8, 16 at Cin 9-10."""
    cc = staged_channels(cin)
    fixed = 4 * (2 * cc // 8 * FLOAT_TILE_A_WORDS + FLOAT_TILE_COLS)
    return (SMEM_BYTES - fixed) // (4 * cc * FLOAT_TILE_ROW_WORDS) - 2


def smallcin_max_pool_f(cin: int, dtype: torch.dtype = torch.float32) -> int:
    """The most pool rows one halo staging of K2's kernel holds at this Cin
    and dtype (``kScChunkRows`` / ``scf_chunk_rows`` / ``kSimtChunkRows``):
    the largest count whose rows + 2 halo rows fit one block's shared
    memory beside the weights, for the kernel the entry launches. The
    bfloat16 tensor-core kernel (Cin <= 8) stages rows + 2 rows of 4
    channel-pair rows of TC_PAIR_WORDS words and 80 x (BLOCK_CO + 8) bf16
    weights; float32 the float smallcin tile
    (:func:`float_tile_max_pool_f`); the SIMT kernel (bfloat16 at Cin 9-10)
    :func:`halo_max_pool_f`. A larger pool_f runs in chunks of this many
    rows (:func:`smallcin_pool_chunks`); the kernel refuses a chunk above
    its own count of the same limit."""
    if dtype == torch.bfloat16:
        if cin <= 8:
            fixed = 2 * TC_SMALLCIN_K * (BLOCK_CO + 8)
            return (SMEM_BYTES - fixed) // (4 * TC_SMALLCIN_PAIRS * TC_PAIR_WORDS) - 2
        return halo_max_pool_f(cin)
    return float_tile_max_pool_f(cin)


def smallcin_pool_chunks(pool_f: int, cin: int,
                         dtype: torch.dtype = torch.float32) -> list[tuple[int, int]]:
    """(first row, rows) of each halo staging K2's kernel walks in one pool
    window: chunks of :func:`smallcin_max_pool_f` rows in order, the last
    one short. The wrapper passes the first chunk's rows to the kernel,
    which walks the window in steps of that many rows just so. The running
    max goes from chunk to chunk in registers, so the pooled output does
    not depend on the chunking; a window that fits one chunk is one
    staging."""
    step = smallcin_max_pool_f(cin, dtype)
    return [(r0, min(step, pool_f - r0)) for r0 in range(0, pool_f, step)]


def conv2d_smallcin_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """K2's kernel (``seld_conv3x3_smallcin``): every tap and channel of a
    tile staged once, Cin <= 10, any pool_f dividing F (the window's rows
    staged in :func:`smallcin_pool_chunks`). bfloat16 at Cin <= 8 runs on
    the tensor cores, at Cin 9-10 SIMT; float32 in split TF32 on the float
    smallcin tile (``smallcin_tf32_kernel``), whose rows are K5's F1 and g_z
    pass's and the block tile's bit for bit. The router sends Cin <= 8 here;
    K5's float32 forward calls it for Cin 9-10 too, so that its pooled rows
    are the conv rows K5's backward recomputes. CPU tensors take
    :func:`conv2d_bn_relu_fpool_plain`."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    b, cin, f, t = x.shape
    if cin > SMALLCIN_MAX_CIN:
        raise ValueError(f"K2's kernel stages at most {SMALLCIN_MAX_CIN} channels, got {cin}")
    cout = w.shape[3]
    chunk = smallcin_pool_chunks(pool_f, cin, x.dtype)[0][1]
    return _launch("conv3x3_smallcin", x, w, scale, bias, pool_f, (b, cout, f // pool_f, t),
                   b, cin, f, t, cout, chunk=chunk)


def conv2d_widecin_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """K3's kernel (``seld_conv3x3_widecin``): Cin walked in chunks, any Cin
    (the router sends Cin % 8 == 0 here), on the block tile that K9's F1
    shares (bfloat16 on ``mma.sync``, float32 in split TF32), so K9's
    forward calls it whatever C is. CPU tensors take
    :func:`conv2d_bn_relu_fpool_plain`."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    b, cin, f, t = x.shape
    cout = w.shape[3]
    return _launch("conv3x3_widecin", x, w, scale, bias, pool_f, (b, cout, f // pool_f, t),
                   b, cin, f, t, cout)


# ---- K2w: the wide pack ------------------------------------------------------

def smallcin_kg(cin: int) -> int:
    """Rows of one (dx, c) group of the wide pack: 16 if 3 * Cin <= 16, else 32."""
    if not 1 <= 3 * cin <= 32:
        raise ValueError(f"the wide pack needs 3 * Cin <= 32, got Cin={cin}")
    return 16 if 3 * cin <= 16 else 32


def smallcin_rows(cin: int) -> int:
    """Rows of each kg group of the wide pack that K2w's float32 kernel
    walks: 3 * Cin rounded up to 8 (its k8 steps). The pack's rows from 3 *
    Cin on are zero by contract, so the rows past this count add nothing
    and are never read."""
    return -(-3 * cin // 8) * 8


def smallcin_tpad(t: int) -> int:
    """Packed frames: T + 1 rounded up to a multiple of 128."""
    return -(-(t + 1) // 128) * 128


def smallcin_pack(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The wide packer (``seld_tpu/ops/pallas/conv2d_pool.py::smallcin_pack``)
    on x (B, Cin, F, T) and w (3, 3, Cin, Cout):

    - p0 (B, F + 2, kg, tpad): the F conv halo rows; row dx * Cin + c of the
      kg holds x[c] shifted by dx - 1 frames (p0[..., dx*Cin + c, t] =
      x[c, t + dx - 1], zero outside), rows >= 3 * Cin zero, frames
      zero-padded to tpad (:func:`smallcin_tpad`);
    - wk (Cout, 3 * kg): weight columns in (dy, (dx, c)) order, zero where
      the pack's rows are.

    Equal, element for element, to the JAX packer's p0 / wk."""
    b, cin, f, t = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    kg, tpad = smallcin_kg(cin), smallcin_tpad(t)
    xt = F.pad(x.transpose(1, 2), (0, 0, 0, 0, 1, 1))          # (B, F + 2, C, T)
    shifted = [F.pad(xt, (1, tpad - t - 1)),                   # x[t - 1]
               F.pad(xt, (0, tpad - t)),                       # x[t]
               F.pad(xt[..., 1:], (0, tpad - t + 1))]          # x[t + 1]
    if kg > 3 * cin:
        shifted.append(xt.new_zeros(b, f + 2, kg - 3 * cin, tpad))
    p0 = torch.cat(shifted, dim=2).contiguous()
    cout = w.shape[3]
    wt = F.pad(w.reshape(3, 3 * cin, cout), (0, 0, 0, kg - 3 * cin))
    wk = wt.reshape(3 * kg, cout).t().contiguous()
    return p0, wk


def conv2d_smallcin_wide_bn_relu_fpool_plain(x, w, scale, bias, pool_f: int) -> torch.Tensor:
    """Plain version of :func:`conv2d_smallcin_wide_bn_relu_fpool`: the pack,
    then per conv row f wk @ p0[:, f:f + 3] flattened to (3 * kg, tpad) in
    float32 (float64 for float64 input), affine, ReLU and pool; frames >= T
    dropped."""
    _check(x, w, scale, bias, pool_f)
    return smallcin_wide_product_plain(*smallcin_pack(x, w), scale, bias, pool_f, x.shape[3],
                                       x.shape[1])


def smallcin_wide_product_plain(p0, wk, scale, bias, pool_f: int, t: int,
                                cin: int) -> torch.Tensor:
    """Plain version of :func:`smallcin_wide_product`: per conv row f wk @
    p0[:, f:f + 3] flattened to (3 * kg, tpad) in float32 (float64 for
    float64 input), over the :func:`smallcin_rows` rows of each kg group
    that the kernel walks, affine, ReLU and pool; frames >= t dropped."""
    adt, f, kg = _acc_dtype(p0), p0.shape[1] - 2, p0.shape[2]
    rows = smallcin_rows(cin)
    stack = torch.cat([p0[:, dy:dy + f, :rows] for dy in range(3)], dim=2)   # (B, F, 3 rows, T')
    wr = torch.cat([wk[:, dy * kg:dy * kg + rows] for dy in range(3)], dim=1)
    y = torch.einsum("ok,bfkt->boft", wr.to(adt), stack.to(adt))
    return _epilogue(y[..., :t], scale, bias, pool_f, p0.dtype).contiguous()


def smallcin_wide_product(p0: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, pool_f: int, t: int, cin: int) -> torch.Tensor:
    """K2w's kernel on a built pack (:func:`smallcin_pack`): p0 (B, F + 2,
    kg, tpad), wk (Cout, 3 * kg) in one dtype, scale/bias (Cout,) float32,
    the input's T frames and Cin channels -> (B, Cout, F/pool_f, T). CUDA
    tensors launch ``seld_conv3x3_smallcin_wide`` (bfloat16 on the tensor
    cores over all kg rows of each group; float32 in split TF32 over the
    :func:`smallcin_rows` rows, the pack's rows past them never read); CPU
    tensors take :func:`smallcin_wide_product_plain`."""
    b, f2, kg, tpad = p0.shape
    f, cout = f2 - 2, wk.shape[0]
    if wk.shape != (cout, 3 * kg) or scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"wk {tuple(wk.shape)}, scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit a pack of kg {kg}")
    if smallcin_kg(cin) != kg:
        raise ValueError(f"a pack of Cin {cin} has kg {smallcin_kg(cin)}, not {kg}")
    if not on_cuda(p0, wk, scale, bias):
        return smallcin_wide_product_plain(p0, wk, scale, bias, pool_f, t, cin)
    return _launch("conv3x3_smallcin_wide", p0, wk, scale, bias, pool_f,
                   (b, cout, f // pool_f, t), b, kg, smallcin_rows(cin), f, t, tpad, cout)


def conv2d_smallcin_wide_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor,
                                       scale: torch.Tensor, bias: torch.Tensor,
                                       pool_f: int) -> torch.Tensor:
    """K2w: the stage through the wide pack, 3 * Cin <= 32. x (B, Cin, F, T),
    w (3, 3, Cin, Cout) in x's dtype, scale/bias (Cout,) float32 -> (B, Cout,
    F/pool_f, T) in x's dtype.

    The pack (:func:`smallcin_pack`) runs in torch, as the JAX package builds
    it in XLA; CUDA tensors then launch K2w's kernel on it
    (:func:`smallcin_wide_product`), CPU tensors take
    :func:`conv2d_smallcin_wide_bn_relu_fpool_plain`."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_smallcin_wide_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    return smallcin_wide_product(*smallcin_pack(x, w), scale, bias, pool_f, x.shape[3],
                                 x.shape[1])


# ---- K10a: im2col -------------------------------------------------------------

def im2col_patches(x: torch.Tensor, k_align: int = 1) -> torch.Tensor:
    """x (B, Cin, F, T) -> patches (B, F, T, 9 * Cin) of the zero-padded
    input, column (dy * 3 + dx) * Cin + c = x[c, f + dy - 1, t + dx - 1]
    (``conv2d_pool.py:129-138``), so patches @ w.reshape(9 * Cin, Cout) is
    the conv; zero columns after them up to a multiple of ``k_align``."""
    b, cin, f, t = x.shape
    xp = F.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1)            # (B, F + 2, T + 2, C)
    cols = [xp[:, dy:dy + f, dx:dx + t] for dy in range(3) for dx in range(3)]
    if (9 * cin) % k_align:
        cols.append(x.new_zeros(b, f, t, -(9 * cin) % k_align))
    return torch.cat(cols, dim=-1).contiguous()


def im2col(x: torch.Tensor, k_align: int = 1) -> torch.Tensor:
    """K10a's patch build: :func:`im2col_patches` in one pass. CUDA tensors
    launch ``seld_im2col_patches`` (x read once, the patches written with
    their zero columns); CPU tensors take :func:`im2col_patches`."""
    if not on_cuda(x):
        return im2col_patches(x, k_align)
    require_contiguous(x=x)
    b, cin, f, t = x.shape
    k_pad = -(-9 * cin // k_align) * k_align
    patches = torch.empty((b, f, t, k_pad), dtype=x.dtype, device=x.device)
    err = _build.load().seld_im2col_patches(x.data_ptr(), patches.data_ptr(), b, cin, f, t,
                                            k_pad, dtype_code(x), stream_handle(x.device))
    _build.check(err, "seld_im2col_patches")
    launch_counts["im2col_patches"] += 1
    return patches


def im2col_operands(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The patches (:func:`im2col`) and the (K, Cout) weights K10a's kernel
    multiplies. The bfloat16 kernel copies 16-byte rows: its K is padded to
    a multiple of 8 (zero patch columns, zero weight rows) and its weight
    rows to a multiple of 8 channels (zero columns); float32 takes them as
    they are."""
    cout = w.shape[3]
    wk = w.reshape(-1, cout)
    if x.dtype != torch.bfloat16:
        return im2col(x), wk
    patches = im2col(x, 8)
    pad = (0, -cout % 8, 0, patches.shape[-1] - wk.shape[0])
    return patches, F.pad(wk, pad).contiguous()


def conv2d_im2col_bn_relu_fpool_plain(x, w, scale, bias, pool_f: int) -> torch.Tensor:
    """Plain version of :func:`conv2d_im2col_bn_relu_fpool`: the patches,
    one product with w.reshape(9 * Cin, Cout) in float32 (float64 for
    float64 input), then affine, ReLU and pool."""
    _check(x, w, scale, bias, pool_f)
    return im2col_product_plain(im2col_patches(x), w.reshape(-1, w.shape[3]), scale, bias,
                                pool_f)


def im2col_product_plain(patches, wk, scale, bias, pool_f: int) -> torch.Tensor:
    """Plain version of :func:`im2col_product`: patches @ wk in float32
    (float64 for float64 input), the first Cout columns, then affine, ReLU
    and pool."""
    adt = _acc_dtype(patches)
    y = torch.matmul(patches.to(adt), wk[:, :scale.shape[0]].to(adt))
    return _epilogue(y.permute(0, 3, 1, 2), scale, bias, pool_f, patches.dtype).contiguous()


def im2col_product(patches: torch.Tensor, wk: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """K10a's kernel on built operands (:func:`im2col_operands`): patches
    (B, F, T, K), wk (K, Cout; bfloat16: K % 8 == 0 and Cout rounded up to
    8 columns) in one dtype, scale/bias (Cout,) float32 -> (B, Cout,
    F/pool_f, T). CUDA tensors launch
    ``seld_conv3x3_im2col`` (bfloat16 on the tensor cores, float32 in split
    TF32 on them); CPU tensors take :func:`im2col_product_plain`."""
    b, f, t, k = patches.shape
    cout = scale.shape[0]
    bf16 = patches.dtype == torch.bfloat16
    if wk.shape != (k, -(-cout // 8) * 8 if bf16 else cout) or (bf16 and k % 8) \
            or bias.shape != (cout,):
        raise ValueError(f"patches {tuple(patches.shape)}, wk {tuple(wk.shape)}, Cout {cout}: "
                         f"not operands of im2col_operands")
    if not on_cuda(patches, wk, scale, bias):
        return im2col_product_plain(patches, wk, scale, bias, pool_f)
    return _launch("conv3x3_im2col", patches, wk, scale, bias, pool_f,
                   (b, cout, f // pool_f, t), b, k, f, t, cout)


def conv2d_im2col_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """K10a: the stage as one K = 9 * Cin product over materialized patches
    (:func:`im2col_operands`, 9x the input bytes), any Cin and T. x (B, Cin,
    F, T), w (3, 3, Cin, Cout) in x's dtype, scale/bias (Cout,) float32 ->
    (B, Cout, F/pool_f, T) in x's dtype. CUDA tensors launch
    ``seld_im2col_patches``, then the product (:func:`im2col_product`); CPU
    tensors take :func:`conv2d_im2col_bn_relu_fpool_plain`."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_im2col_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    b, _, f, t = x.shape
    _check_launch(x, w, scale, bias, (b, w.shape[3], f // pool_f, t))   # before the patches
    return im2col_product(*im2col_operands(x, w), scale, bias, pool_f)


# ---- K10b: per-tap windows ------------------------------------------------------

def conv2d_windows_bn_relu_fpool(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor, pool_f: int) -> torch.Tensor:
    """K10b, the JAX package's ``conv2d_bn_relu_fpool``: nine per-tap
    products summed over Cin, any Cin >= 1, T and pool_f dividing F. x (B,
    Cin, F, T), w (3, 3, Cin, Cout) in x's dtype, scale/bias (Cout,) float32
    -> (B, Cout, F/pool_f, T) in x's dtype. CUDA tensors launch
    ``seld_conv3x3_windows``; CPU tensors take
    :func:`conv2d_bn_relu_fpool_plain`."""
    _check(x, w, scale, bias, pool_f)
    if not on_cuda(x, w, scale, bias):
        return conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f)
    b, cin, f, t = x.shape
    cout = w.shape[3]
    return _launch("conv3x3_windows", x, w, scale, bias, pool_f, (b, cout, f // pool_f, t),
                   b, cin, f, t, cout)
