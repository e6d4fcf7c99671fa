"""Seeded synthetic Task-2 features and targets.

The port's own copy of ``seld_tpu/data/synthetic.py::make_task2_example``
and ``::gen_fake_task2_dataset`` (reference layout: predictors (C, F, T),
targets (label_frames, 4 * classes * overlaps) = SED columns then DOA
columns), plus a batch maker for the train step. numpy only, drawn from a
``numpy.random.Generator``.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def make_task2_example(rng, channels: int = 8, freq: int = 32, time_frames: int = 160,
                       label_frames: int = 20, classes: int = 14, overlaps: int = 3,
                       sed_rate: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic (predictor, target) pair in the reference tensor layout;
    each (frame, class, overlap) slot holds an event with probability
    ``sed_rate`` (the JAX package's generator draws 0.05)."""
    x = rng.standard_normal((channels, freq, time_frames)).astype(np.float32)
    sed = (rng.random((label_frames, classes * overlaps)) < sed_rate).astype(np.float32)
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


def gen_fake_task2_dataset(out_dir: str, n_train: int = 8, n_val: int = 4, n_test: int = 4,
                           channels: int = 8, freq: int = 32, time_frames: int = 160,
                           label_frames: int = 20, seed: int = 0,
                           sed_rate: float = 0.05) -> dict:
    """Write the 6-pickle Task-2 layout the trainer reads
    (``task2_{predictors,target}_{train,validation,test}.pkl``); returns
    {split: (predictors path, target path)}. The same seed (and the default
    ``sed_rate``) gives the same files as the JAX package's generator."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split, n in (("train", n_train), ("validation", n_val), ("test", n_test)):
        pairs = [make_task2_example(rng, channels, freq, time_frames, label_frames,
                                    sed_rate=sed_rate) for _ in range(n)]
        px = os.path.join(out_dir, f"task2_predictors_{split}.pkl")
        py = os.path.join(out_dir, f"task2_target_{split}.pkl")
        for path, arr in ((px, np.stack([p[0] for p in pairs])),
                          (py, np.stack([p[1] for p in pairs]))):
            with open(path, "wb") as f:
                pickle.dump(arr, f)
        paths[split] = (px, py)
    return paths
