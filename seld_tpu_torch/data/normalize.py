"""Dataset normalization modes.

The port's own copy of ``seld_tpu/data/normalize.py`` (numpy only):
``normalize_dataset`` for splits held in memory, and for the ``.seldpak``
loader's batches ``compute_norm_stats`` (each split's statistics streamed
once out of its memory map) with ``make_batch_transform`` (the same
normalization, one gathered batch at a time). It reimplements the reference
trainer's normalization block (reference ``train.py:241-424``):

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

from typing import Dict, Optional

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


def compute_norm_stats(x: np.ndarray, mode: str = "True", n_mics: int = 1,
                       phase: bool = False, domain: str = "DQ") -> Optional[Dict[str, float]]:
    """One split's statistics for :func:`make_batch_transform`: for z-score
    the split-global mean / std of each channel group, summed in float64
    (the reference's whole-split statistics, train.py:344-408), streamed
    from ``x`` (a memory-mapped view is read a chunk of rows at a time).
    UnitNorm and 'off' need none (None)."""
    if mode in _OFF:
        return None
    if mode in _DQ_MODES and n_mics == 2 and domain in _DQ_DOMAINS:
        if phase:
            raise ValueError(
                "DATASET NORMALIZATION FOR PHASE DUAL QUATERNION NOT YET IMPLEMENTED"
            )
        return None
    n_mag = 4 * n_mics
    mm, ms = _streaming_mean_std(x, 0, n_mag)
    stats = {"mag_mean": mm, "mag_std": ms}
    if phase:
        stats["phase_mean"], stats["phase_std"] = _streaming_mean_std(x, n_mag, x.shape[1])
    return stats


def _streaming_mean_std(x, c0: int, c1: int, rows_per_chunk: int = 16):
    """Split-global mean / std of x[:, c0:c1] from float64 sums and sums of
    squares over chunks of rows, so that peak memory is about one chunk.
    Population std (ddof 0), as :func:`normalize_dataset`'s np.std; the
    reference's torch.std is ddof 1, a < 1e-8 relative difference at split
    scale (reference train.py:344-408)."""
    n, total, sq = 0, 0.0, 0.0
    for i in range(0, x.shape[0], rows_per_chunk):
        c = np.asarray(x[i:i + rows_per_chunk, c0:c1], dtype=np.float64)
        n += c.size
        total += float(c.sum())
        sq += float(np.square(c).sum())
    mean = total / n
    return float(mean), float(np.sqrt(max(sq / n - mean * mean, 0.0)))


def make_batch_transform(mode: str = "True", n_mics: int = 1, phase: bool = False,
                         domain: str = "DQ", stats: Optional[Dict[str, float]] = None):
    """``fn(batch) -> batch``: :func:`normalize_dataset`'s normalization of
    one freshly gathered batch. UnitNorm is per sample; z-score takes the
    split statistics of :func:`compute_norm_stats`."""
    if mode in _OFF:
        return lambda x: x
    if mode in _DQ_MODES and n_mics == 2 and domain in _DQ_DOMAINS:
        if phase:
            raise ValueError(
                "DATASET NORMALIZATION FOR PHASE DUAL QUATERNION NOT YET IMPLEMENTED"
            )
        return dq_unitnorm
    if stats is None:
        raise ValueError("the z-score transform needs the split's compute_norm_stats()")
    n_mag = 4 * n_mics

    def transform(x: np.ndarray) -> np.ndarray:
        x = np.array(x, copy=True, dtype=np.float64)
        x[:, :n_mag] -= stats["mag_mean"]
        x[:, :n_mag] /= stats["mag_std"]
        if phase:
            x[:, n_mag:] -= stats["phase_mean"]
            x[:, n_mag:] /= stats["phase_std"]
        return x.astype(np.float32)

    return transform


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
