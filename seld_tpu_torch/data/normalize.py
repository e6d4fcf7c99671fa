"""Dataset normalization modes.

The port's own copy of ``seld_tpu/data/normalize.py`` (``normalize_dataset``,
``dq_unitnorm``, the z-score modes; numpy only). It reimplements the
reference trainer's normalization block (reference ``train.py:241-424``):

- ``'UnitNorm'`` family (``DQ_Normalization``/``UnitNormNormalization``/
  ``UnitNorm``): dual-quaternion Gram-Schmidt on the first 8 magnitude
  channels — the dual part ``p`` is made orthogonal to the quaternion part
  ``q`` (using the *unnormalized* q, as the reference does), then ``q`` is
  unit-normalized (``train.py:257-308``). Only defined for n_mics=2 + DQ
  domain; phase+DQ raises, matching ``train.py:310``.
- z-score otherwise: per magnitude group (first 4 or 8 channels) and, with
  phase enabled, per phase group, each split normalized with its own
  mean/std (``train.py:341-408``).
- any value in {'False','false','None','none'} disables normalization.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_DQ_MODES = {"DQ_Normalization", "UnitNormNormalization", "UnitNorm"}
_OFF = {"False", "false", "None", "none"}
_DQ_DOMAINS = {"DQ", "dq", "dQ", "Dual_Quaternion", "dual_quaternion"}


def dq_unitnorm(x: np.ndarray) -> np.ndarray:
    """Dual-quaternion UnitNorm on the first 8 channels of (N, C, F, T)."""
    x = np.array(x, copy=True)
    q = x[:, 0:4].astype(np.float64)
    p = x[:, 4:8].astype(np.float64)
    denom0 = np.sum(q * q, axis=1, keepdims=True)
    denom1 = np.sqrt(denom0)
    cross = np.sum(q * p, axis=1, keepdims=True)
    p = p - cross / denom0 * q
    q = q / denom1
    x[:, 0:4] = q.astype(x.dtype)
    x[:, 4:8] = p.astype(x.dtype)
    return x


def _zscore_inplace(x: np.ndarray, sl: slice) -> None:
    mean = np.mean(x[:, sl])
    std = np.std(x[:, sl])
    x[:, sl] -= mean
    x[:, sl] /= std


def normalize_dataset(
    predictors: Dict[str, np.ndarray],
    mode: str = "True",
    n_mics: int = 1,
    phase: bool = False,
    domain: str = "DQ",
) -> Dict[str, np.ndarray]:
    """Normalize the train/val/test predictor dict.

    Each split is normalized independently with its own statistics, exactly
    like the reference (which computes mean/std per split,
    ``train.py:344-408``).
    """
    if mode in _OFF:
        return predictors
    out = {}
    if mode in _DQ_MODES and n_mics == 2 and domain in _DQ_DOMAINS:
        if phase:
            raise ValueError(
                "DATASET NORMALIZATION FOR PHASE DUAL QUATERNION NOT YET IMPLEMENTED"
            )
        for split, x in predictors.items():
            out[split] = dq_unitnorm(np.asarray(x))
        return out
    n_mag = 4 * n_mics
    for split, x in predictors.items():
        x = np.array(x, copy=True, dtype=np.float64)
        _zscore_inplace(x, slice(0, n_mag))
        if phase:
            _zscore_inplace(x, slice(n_mag, None))
        out[split] = x.astype(np.float32)
    return out
