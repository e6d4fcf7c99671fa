"""The serving kernels as ``torch.library`` custom ops (namespace ``seld``).

One op per serving-side C entry point, so that ``torch.export`` records a
kernel call as one node of its graph and an exported artifact launches the
kernel when it runs (``seld_tpu_torch/export_serving.py``). Each op has

- a CPU impl: the kernel's plain version, beside its wrapper;
- a CUDA impl (the wrapper module's ``*_cuda`` function): it checks its
  operands, launches the kernel and adds one to :data:`launch_counts`, or
  raises; a CUDA tensor never reaches a plain version;
- a fake: the exact shape and dtype of the output, from the inputs' shapes.

=========================  ==========================================  ======
op                         kernel (entry points)                       ID
=========================  ==========================================  ======
``seld::stft_mag``         ``seld_stft_mag_tc`` / ``_fft`` / ``_mag``  K1
``seld::conv3x3_fpool``    ``seld_conv3x3_smallcin`` / ``_widecin`` /  K2, K3,
                           ``_windows``, named by ``kernel``           K10b
``seld::smallcin_wide_``   ``seld_conv3x3_smallcin_wide`` (the pack    K2w
``product``                stays torch ops around it)
``seld::flash_attn_fwd``   ``seld_flash_attn_fwd`` (out and lse)       K4
``seld::hamilton_matmul``  ``seld_hamilton_matmul``                    K7
``seld::int8_matmul``      ``seld_int8_matmul`` (two launches)         K8
=========================  ==========================================  ======

The wrappers (``stft.stft_mag``, ``conv2d_pool.conv2d_*_bn_relu_fpool``,
``attention.flash_attention``, ``qmatmul.hamilton_matmul``,
``quant.int8_matmul``) keep their names and signatures and call the ops;
what depends only on shapes and dtypes (K1's route, K2's pool chunks, K4's
head-dim padding, K8's row tile) is decided in the CUDA impls. The ops have
no autograd formula: K4 and K7 are differentiated by the autograd Functions
around their wrappers (``_FlashAttentionFn``, ``_HamiltonMatmulFn``), whose
forwards run with grad off, and K8's wrapper detaches its operands.

A process that loads an artifact imports this module first; it imports
nothing but torch and the kernel modules. Importing it turns TF32 off
(:func:`seld_tpu_torch.disable_tf32`): an artifact's float32 convolutions
and matmuls that are not port kernels (``aten.convolution`` carries no
precision of its own) then run in full float32 on a serving host, as
eager serving and the JAX package's 'highest' precision do.
"""

from __future__ import annotations

import torch

from seld_tpu_torch import disable_tf32
from seld_tpu_torch.ops.kernels import attention, conv2d_pool, qmatmul, quant, stft

disable_tf32()


def _op(name: str, schema: str, cpu, cuda, fake):
    """Register ``seld::<name>`` with its CPU impl, CUDA impl and fake."""
    op = torch.library.custom_op(f"seld::{name}", cpu, mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _stft_fake(x, nperseg, noverlap, out_dtype):
    t = stft.n_frames(x.shape[-1], nperseg, noverlap)
    return x.new_empty((*x.shape[:-1], t, nperseg // 2), dtype=out_dtype)


def _fpool_fake(x, w, scale, bias, pool_f, kernel):
    b, _, f, t = x.shape
    return x.new_empty((b, w.shape[3], f // pool_f, t))


def _wide_fake(p0, wk, scale, bias, pool_f, t, cin):
    return p0.new_empty((p0.shape[0], wk.shape[0], (p0.shape[1] - 2) // pool_f, t))


def _flash_fake(q, k, v, scale):
    b, t, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, t),
                                             dtype=torch.promote_types(q.dtype, torch.float32))


def _contiguous_out(out, lse):
    """The plain version's out in the kernel's layout, as the fake gives it."""
    return out.contiguous(), lse


def _hamilton_fake(x2d, comps, bias, n_comp, linear_table):
    return x2d.new_empty((x2d.shape[0], n_comp * comps.shape[2]))


def _int8_fake(x2, w_q, w_scale, bias):
    return x2.new_empty((x2.shape[0], w_q.shape[1]))


stft_mag = _op(
    "stft_mag", "(Tensor x, int nperseg, int noverlap, ScalarType out_dtype) -> Tensor",
    stft.stft_mag_plain, stft.stft_mag_cuda, _stft_fake)
conv3x3_fpool = _op(
    "conv3x3_fpool",
    "(Tensor x, Tensor w, Tensor scale, Tensor bias, int pool_f, str kernel) -> Tensor",
    lambda x, w, scale, bias, pool_f, kernel:
        conv2d_pool.conv2d_bn_relu_fpool_plain(x, w, scale, bias, pool_f),
    conv2d_pool.conv3x3_fpool_cuda, _fpool_fake)
smallcin_wide_product = _op(
    "smallcin_wide_product",
    "(Tensor p0, Tensor wk, Tensor scale, Tensor bias, int pool_f, int t, int cin) -> Tensor",
    conv2d_pool.smallcin_wide_product_plain, conv2d_pool.smallcin_wide_product_cuda,
    _wide_fake)
flash_attn_fwd = _op(
    "flash_attn_fwd", "(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)",
    lambda q, k, v, scale: _contiguous_out(*attention.flash_attention_plain(q, k, v, scale)),
    attention.flash_attention_cuda, _flash_fake)
hamilton_matmul = _op(
    "hamilton_matmul",
    "(Tensor x2d, Tensor comps, Tensor? bias, int n_comp, bool linear_table) -> Tensor",
    qmatmul.hamilton_matmul_plain, qmatmul.hamilton_matmul_cuda, _hamilton_fake)
int8_matmul = _op(
    "int8_matmul", "(Tensor x2, Tensor w_q, Tensor w_scale, Tensor? bias) -> Tensor",
    quant.int8_matmul_plain, quant.int8_matmul_cuda, _int8_fake)

