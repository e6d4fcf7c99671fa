"""The split-TF32 arithmetic of the float32 tensor-core kernels (K6's
``flash_dq_tf32_kernel`` / ``flash_dkv_tf32_kernel`` and K9's
``ct_dw_tf32_kernel``, helpers in ``csrc/mma.cuh``), in plain PyTorch for
the tests: no wrapper calls it.

A float32 x is split as x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
tf32 rounding as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, the low 13 of the 23 fraction bits zero). A product a b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 products, each exact in
float64 (two TF32 values' product has 22 significant bits); the kernels add
them on float accumulators.
"""

from __future__ import annotations

import torch

_LOW = 0x1FFF         # the 13 fraction bits TF32 drops
_HALF = 0x1000        # half a TF32 ulp in them
_MAG = 0x7FFFFFFF
_EXP = 0x7F800000


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(bits: torch.Tensor, shape) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32).view(shape)


def tf32_add_half_and_mask(x: torch.Tensor) -> torch.Tensor:
    """The kernels' cheap rounding of lo: half a TF32 ulp added to the bits,
    the low 13 bits cleared, with no test for non-finite values. For finite x
    it is :func:`tf32_round_plain`'s result; a NaN whose fraction's top ten
    bits are ones (0x7fffffff) carries into the sign and comes out a zero,
    which is why hi is not taken this way."""
    return _float((_bits(x) + _HALF) & ~_LOW & 0xFFFFFFFF, x.shape)


def tf32_round_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` (the kernels' hi):
    the magnitude's bits plus half a TF32 ulp, the low 13 bits then cleared
    (ties away from zero; a carry moves into the exponent); infinities and
    NaNs as they are."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round_plain takes float32, got {x.dtype}")
    bits = _bits(x)
    sign, mag = bits & 0x80000000, bits & _MAG
    rounded = torch.where((mag & _EXP) == _EXP, mag, (mag + _HALF) & ~_LOW & 0xFFFFFFFF)
    return _float(sign | rounded, x.shape)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of ``split_tf32``: hi = tf32(x) as :func:`tf32_round_plain`,
    lo = :func:`tf32_add_half_and_mask` of x - hi; both float32 with their
    low 13 fraction bits zero. For a non-finite x, hi is a NaN or the
    infinity, lo a NaN or a zero."""
    hi = tf32_round_plain(x)
    return hi, tf32_add_half_and_mask(x - hi)
