"""SELD loss: weighted BCE (SED) + MSE (DOA).

Counterpart of ``seld_tpu/training/loss.py`` (reference ``seld_loss``): the
joint target's first ``classes * overlaps`` columns are SED, the rest DOA;
loss = BCE(sed, t_sed) * sed_weight + MSE(doa, t_doa) * doa_weight, both
mean-reduced. BCE log terms are clamped at -100 like torch.nn.BCELoss.
"""

from __future__ import annotations

import torch


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities, torch.nn.BCELoss semantics."""
    log_p = torch.clamp(torch.log(pred), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-pred), min=-100.0)
    return -torch.mean(target * log_p + (1.0 - target) * log_1mp)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def seld_loss(sed: torch.Tensor, doa: torch.Tensor, target: torch.Tensor,
              output_classes: int = 14, class_overlaps: int = 3,
              sed_weight: float = 1.0, doa_weight: float = 5.0) -> torch.Tensor:
    n_sed = int(output_classes * class_overlaps)
    target = target.to(sed.dtype)
    return (bce_loss(sed, target[..., :n_sed]) * sed_weight
            + mse_loss(doa, target[..., n_sed:]) * doa_weight)
