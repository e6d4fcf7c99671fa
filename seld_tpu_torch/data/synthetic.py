"""Seeded synthetic Task-2 features and targets.

The port's own copy of ``seld_tpu/data/synthetic.py::make_task2_example``
(reference layout: predictors (C, F, T), targets (label_frames, 4 * classes
* overlaps) = SED columns then DOA columns), plus a batch maker for the
train step. numpy only, drawn from a ``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_task2_example(rng, channels: int = 8, freq: int = 32, time_frames: int = 160,
                       label_frames: int = 20, classes: int = 14,
                       overlaps: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic (predictor, target) pair in the reference tensor layout."""
    x = rng.standard_normal((channels, freq, time_frames)).astype(np.float32)
    sed = (rng.random((label_frames, classes * overlaps)) < 0.05).astype(np.float32)
    doa = (rng.random((label_frames, classes * overlaps * 3)) * 2 - 1).astype(np.float32)
    doa = doa * sed.repeat(3, axis=1)  # locations only where events exist
    return x, np.concatenate([sed, doa], axis=1).astype(np.float32)


def make_task2_batch(rng, batch: int, channels: int = 8, freq: int = 32,
                     time_frames: int = 160, label_frames: int = 20, classes: int = 14,
                     overlaps: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``batch`` examples stacked: x (B, C, F, T), y (B, label_frames,
    4 * classes * overlaps) float32 (168 columns at 14 classes x 3 overlaps:
    42 SED + 126 DOA)."""
    pairs = [make_task2_example(rng, channels, freq, time_frames, label_frames, classes,
                                overlaps) for _ in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
