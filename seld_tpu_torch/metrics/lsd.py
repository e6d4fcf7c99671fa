"""L3DAS21 Task-2 location-sensitive detection (LSD) metric.

The port's own copy of ``seld_tpu/metrics/lsd.py::location_sensitive_detection``
(numpy only).

Semantics match reference ``metrics.py:123-208``: per frame, a TRUE event is
"matched" iff any PREDICTED event in the same frame has the same class AND
cartesian distance < ``spatial_threshold``; then TP += matched,
FN += len(true) - matched, FP += len(pred) - matched. The reference's edge
behavior is preserved: frames with no true events contribute all predictions
as FP; frames with no predictions contribute all trues as FN.

Implementation is vectorized with numpy (the reference loops per frame per
event pair); on 600-frame clips this is ~100x faster, and it stays on host —
the metric is decode-heavy, not FLOP-heavy.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np


def _counts_per_frame(events: np.ndarray, n_frames: int) -> np.ndarray:
    counts = np.zeros(n_frames, dtype=np.int64)
    if len(events):
        np.add.at(counts, events[:, 0].astype(np.int64), 1)
    return counts


def location_sensitive_detection(
    pred,
    true,
    n_frames: int = 100,
    spatial_threshold: float = 2.0,
    from_csv: bool = False,
    verbose: bool = False,
) -> Tuple[int, int, int, float]:
    """Returns (TP, FP, FN, F_score). Inputs are (N, 5) event arrays
    ``[frame, class, x, y, z]`` or CSV paths when ``from_csv``."""
    if from_csv:
        import pandas as pd

        pred = pd.read_csv(pred, sep=",", header=None).values
        true = pd.read_csv(true, sep=",", header=None).values
    pred = np.asarray(pred, dtype=np.float64).reshape(-1, 5) if len(np.atleast_1d(pred)) else np.empty((0, 5))
    true = np.asarray(true, dtype=np.float64).reshape(-1, 5) if len(np.atleast_1d(true)) else np.empty((0, 5))

    n_true = _counts_per_frame(true, n_frames)
    n_pred = _counts_per_frame(pred, n_frames)

    matched_per_frame = np.zeros(n_frames, dtype=np.int64)
    if len(true) and len(pred):
        # a true event can only match a prediction with the SAME frame and
        # class, and there are at most max_overlaps of those — so instead of
        # the dense (N_true, N_pred) pairwise distance (the old form: ~12M
        # doubles per 600-frame clip and ~90% of the whole metric pass),
        # sort predictions by a (frame, class) key and compare each true
        # event only against its own key group via searchsorted.
        n_cls = float(max(true[:, 1].max(), pred[:, 1].max())) + 1.0
        pred_key = pred[:, 0] * n_cls + pred[:, 1]
        order = np.argsort(pred_key, kind="stable")
        pred_key = pred_key[order]
        pred_xyz = pred[order, 2:5]
        true_key = true[:, 0] * n_cls + true[:, 1]
        lo = np.searchsorted(pred_key, true_key, "left")
        hi = np.searchsorted(pred_key, true_key, "right")
        width = int((hi - lo).max())
        if width:
            idx = lo[:, None] + np.arange(width)[None, :]
            valid = idx < hi[:, None]
            diff = pred_xyz[np.minimum(idx, len(pred) - 1)] - true[:, None, 2:5]
            dist2 = np.einsum("ijk,ijk->ij", diff, diff)
            close = dist2 < spatial_threshold**2 if spatial_threshold >= 0 else np.zeros_like(valid)
            match_any = np.any(valid & close, axis=1)
            np.add.at(matched_per_frame, true[match_any, 0].astype(np.int64), 1)

    # frames where both sides are nonempty use matched counts; one-sided
    # frames dump everything into FP or FN (reference metrics.py:153-156)
    both = (n_true > 0) & (n_pred > 0)
    TP = int(matched_per_frame[both].sum())
    FN = int((n_true[both] - matched_per_frame[both]).sum() + n_true[~both].sum())
    FP = int((n_pred[both] - matched_per_frame[both]).sum() + n_pred[~both].sum())

    eps = sys.float_info.epsilon
    precision = TP / (TP + FP + eps)
    recall = TP / (TP + FN + eps)
    F_score = 2 * precision * recall / (precision + recall + eps)
    if verbose:
        print(f"TP {TP} FP {FP} FN {FN} F {F_score:.4f} P {precision:.4f} R {recall:.4f}")
    return TP, FP, FN, F_score
