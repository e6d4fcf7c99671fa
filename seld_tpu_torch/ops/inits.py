"""Weight initialization from an explicit ``torch.Generator``.

Counterpart of ``seld_tpu/ops/inits.py`` (the reference's quaternion init
schemes) and of the flax initializers the JAX modules use. The draws follow
the same distributions; the random streams differ from JAX's, so these are
held to the JAX package by statistics only. Draws happen in float32 on the
generator's device; callers move the result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out): per-component features times the receptive field."""
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[:-2]))
    return shape[-2] * rf, shape[-1] * rf


def _scale(criterion: str, fan_in: int, fan_out: int) -> float:
    if criterion == "glorot":
        return 1.0 / math.sqrt(2 * (fan_in + fan_out))
    if criterion == "he":
        return 1.0 / math.sqrt(2 * fan_in)
    raise ValueError(f"Invalid criterion: {criterion}")


def _uniform(shape, lo: float, hi: float, generator) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _normal(shape, generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=generator.device)


def _unit_imag(shape, generator) -> torch.Tensor:
    """Unit-norm purely-imaginary 3-vectors, one per weight element: (3, *shape)."""
    v = _normal((3, *shape), generator)
    return v / (torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)) + 1e-4)


def _polar(modulus, shape, generator) -> torch.Tensor:
    v = _unit_imag(shape, generator)
    phase = _uniform(shape, -math.pi, math.pi, generator)
    sin_p = torch.sin(phase)
    return torch.stack([modulus * torch.cos(phase), modulus * v[0] * sin_p,
                        modulus * v[1] * sin_p, modulus * v[2] * sin_p])


def quaternion_init(shape, generator, criterion: str = "glorot") -> torch.Tensor:
    """Polar init: modulus ~ U(-s, s), phase ~ U(-pi, pi), random unit axis."""
    s = _scale(criterion, *_fans(shape))
    return _polar(_uniform(shape, -s, s, generator), shape, generator)


def dq_quaternion_init(shape, generator, criterion: str = "glorot") -> torch.Tensor:
    """DQ variant: chi(4)-distributed modulus of scale s (the norm of four
    standard normals, as sqrt(2 Gamma(2, 1)) in the JAX package)."""
    s = _scale(criterion, *_fans(shape))
    modulus = s * torch.sqrt(torch.sum(_normal((4, *shape), generator) ** 2, dim=0))
    return _polar(modulus, shape, generator)


def unitary_init(shape, generator, criterion: str = "he") -> torch.Tensor:
    """Unit quaternions from normalized 4-vectors."""
    v = _normal((4, *shape), generator)
    return v / (torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)) + 1e-4)


def random_init(shape, generator, criterion: str = "glorot") -> torch.Tensor:
    """Scaled uniform components in [0, s)."""
    s = _scale(criterion, *_fans(shape))
    return _uniform((4, *shape), 0.0, 1.0, generator) * s


_WINIT = {"quaternion": quaternion_init, "unitary": unitary_init, "random": random_init}


def component_init(shape: Sequence[int], generator: torch.Generator, n_components: int = 4,
                   weight_init: str = "quaternion", criterion: str = "glorot",
                   dq_chi: Optional[bool] = None) -> torch.Tensor:
    """Stacked component weight (n_components, *shape); 8 components are two
    independent quaternion draws (chi(4) modulus unless ``dq_chi=False``)."""
    shape = tuple(shape)
    if n_components == 4:
        return _WINIT[weight_init](shape, generator, criterion=criterion)
    if n_components == 8:
        use_chi = True if dq_chi is None else dq_chi
        fn = dq_quaternion_init if weight_init == "quaternion" and use_chi else _WINIT[weight_init]
        return torch.cat([fn(shape, generator, criterion=criterion),
                          fn(shape, generator, criterion=criterion)])
    raise ValueError(f"n_components must be 4 or 8, got {n_components}")


def he_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """flax ``he_uniform(in_axis=-2, out_axis=-1)`` for a (*k, cin, cout) kernel."""
    fan_in = _fans(tuple(shape))[0]
    lim = math.sqrt(6.0 / fan_in)
    return _uniform(shape, -lim, lim, generator)


def lecun_normal(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal`` (the nn.Dense default) for an (in, out) kernel:
    normal truncated to 2 standard deviations, variance 1/fan_in."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = _uniform(shape, lo, hi, generator)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    return z * std
