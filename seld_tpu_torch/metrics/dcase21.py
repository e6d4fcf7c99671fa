"""DCASE21 joint SELD metrics (location-sensitive detection + class-sensitive
localization) with multitrack Hungarian matching.

The port's own copy of ``seld_tpu/metrics/dcase21.py`` (``SELDMetrics``,
``segment_labels`` and the distances they use; numpy and scipy).

Accumulator semantics match reference ``Dcase21_metrics.py:4-154`` (itself the
DCASE 2021 evaluation algorithm): predictions/references are compared per
1-second block per class; frame-wise DOA sets are matched with the Hungarian
algorithm on great-circle distances; per matched reference track the average
spatial distance decides TP (<= doa_threshold) vs FP; substitution /
deletion / insertion counts feed ER. Quirks preserved for score parity,
including the reference's use of the *predicted* DOA count for the FN update
when frame alignment finds no tracks (Dcase21_metrics.py:106-110).

Distances are vectorized numpy; the Hungarian assignment stays on host via
scipy (tiny cost matrices — at most overlaps x overlaps).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

eps = np.finfo(float).eps


def distance_between_spherical_coordinates_rad(az1, ele1, az2, ele2):
    """Great-circle distance (degrees) between spherical coordinates in radians."""
    dist = np.sin(ele1) * np.sin(ele2) + np.cos(ele1) * np.cos(ele2) * np.cos(
        np.abs(az1 - az2)
    )
    return np.arccos(np.clip(dist, -1, 1)) * 180.0 / np.pi


def distance_between_cartesian_coordinates(x1, y1, z1, x2, y2, z2):
    """Angular distance (degrees) between cartesian vectors (normalized)."""
    n1 = np.sqrt(x1 ** 2 + y1 ** 2 + z1 ** 2 + 1e-10)
    n2 = np.sqrt(x2 ** 2 + y2 ** 2 + z2 ** 2 + 1e-10)
    dist = (x1 * x2 + y1 * y2 + z1 * z2) / (n1 * n2)
    return np.arccos(np.clip(dist, -1, 1)) * 180.0 / np.pi


def least_distance_between_gt_pred(gt_list: np.ndarray, pred_list: np.ndarray):
    """Hungarian-matched distances between two DOA sets.

    gt_list: (G, 3) cartesian or (G, 2) polar radians; pred_list likewise.
    Returns (matched costs, row indices, col indices).
    """
    gt_len, pred_len = gt_list.shape[0], pred_list.shape[0]
    cost = np.zeros((gt_len, pred_len))
    if gt_len and pred_len:
        if gt_list.shape[-1] == 3:
            cost = distance_between_cartesian_coordinates(
                gt_list[:, None, 0], gt_list[:, None, 1], gt_list[:, None, 2],
                pred_list[None, :, 0], pred_list[None, :, 1], pred_list[None, :, 2],
            )
        else:
            cost = distance_between_spherical_coordinates_rad(
                gt_list[:, None, 0], gt_list[:, None, 1],
                pred_list[None, :, 0], pred_list[None, :, 1],
            )
    row_ind, col_ind = linear_sum_assignment(cost)
    return cost[row_ind, col_ind], row_ind, col_ind


def segment_labels(pred_dict, max_frames: int, nb_label_frames_1s: int = 10):
    """Collect frame-wise events into 1-second blocks.

    Input {frame: [[class, x, y, z, slot], ...]}; output
    {block: {class: [[frame_keys_within_block], [per-frame DOA lists]]}}
    with each class entry wrapped in a single-element list, matching the
    reference structure (Dcase21_metrics.py:239-278).
    """
    nb_blocks = int(np.ceil(max_frames / float(nb_label_frames_1s)))
    output = {b: {} for b in range(nb_blocks)}
    for frame_start in range(0, max_frames, nb_label_frames_1s):
        block = frame_start // nb_label_frames_1s
        loc_dict = {}
        for frame in range(frame_start, frame_start + nb_label_frames_1s):
            if frame not in pred_dict:
                continue
            for value in pred_dict[frame]:
                cls = value[0]
                loc_dict.setdefault(cls, {}).setdefault(frame - frame_start, []).append(
                    value[1:]
                )
        for cls, frames in loc_dict.items():
            keys = list(frames.keys())
            values = [frames[k] for k in keys]
            output[block].setdefault(cls, []).append([keys, values])
    return output


class SELDMetrics:
    """Accumulator for the DCASE21 joint metrics.

    update with (pred_blocks, gt_blocks) from :func:`segment_labels`; read
    final (ER, F, LE, LR) from :meth:`compute_seld_scores`.
    """

    def __init__(self, doa_threshold: float = 20, nb_classes: int = 14):
        self._nb_classes = nb_classes
        self._spatial_T = doa_threshold
        self._TP = self._FP = self._FN = 0
        self._S = self._D = self._I = 0
        self._Nref = 0
        self._total_DE = 0.0
        self._DE_TP = self._DE_FP = self._DE_FN = 0

    def compute_seld_scores(self):
        ER = (self._S + self._D + self._I) / float(self._Nref + eps)
        F = self._TP / (eps + self._TP + 0.5 * (self._FP + self._FN))
        LE = self._total_DE / float(self._DE_TP + eps) if self._DE_TP else 180.0
        LR = self._DE_TP / (eps + self._DE_TP + self._DE_FN)
        return ER, F, LE, LR

    def update_seld_scores(self, pred, gt):
        for block in range(len(gt)):
            loc_FN = loc_FP = 0
            for cls in range(self._nb_classes):
                gt_entry = gt[block].get(cls)
                pred_entry = pred[block].get(cls)
                nb_gt = (
                    max(len(v) for v in gt_entry[0][1]) if gt_entry is not None else None
                )
                nb_pred = (
                    max(len(v) for v in pred_entry[0][1]) if pred_entry is not None else None
                )
                if nb_gt is not None:
                    self._Nref += nb_gt
                if gt_entry is not None and pred_entry is not None:
                    matched_dist = {}
                    matched_cnt = {}
                    gt_frames, gt_values = gt_entry[0]
                    pred_frames, pred_values = pred_entry[0]
                    for g_idx, g_frame in enumerate(gt_frames):
                        if g_frame not in pred_frames:
                            continue
                        gt_arr = np.array(gt_values[g_idx])
                        gt_doas = gt_arr[:, :-1]
                        p_idx = pred_frames.index(g_frame)
                        pred_arr = np.array(pred_values[p_idx])
                        pred_doas = pred_arr[:, :-1]
                        if gt_doas.shape[-1] == 2:
                            gt_doas = gt_doas * np.pi / 180.0
                            pred_doas = pred_doas * np.pi / 180.0
                        dists, rows, _ = least_distance_between_gt_pred(gt_doas, pred_doas)
                        for d_i, dist in enumerate(dists):
                            track = rows[d_i]
                            matched_dist.setdefault(track, []).append(dist)
                            matched_cnt.setdefault(track, []).append(p_idx)
                    if not matched_dist:
                        # reference quirk: counts the PREDICTED DOAs as FN here
                        loc_FN += nb_pred
                        self._FN += nb_pred
                        self._DE_FN += nb_pred
                    else:
                        for track, dists in matched_dist.items():
                            avg = sum(dists) / len(matched_cnt[track])
                            self._total_DE += avg
                            self._DE_TP += 1
                            if avg <= self._spatial_T:
                                self._TP += 1
                            else:
                                loc_FP += 1
                                self._FP += 1
                        if nb_pred > nb_gt:
                            loc_FP += nb_pred - nb_gt
                            self._FP += nb_pred - nb_gt
                            self._DE_FP += nb_pred - nb_gt
                        elif nb_pred < nb_gt:
                            loc_FN += nb_gt - nb_pred
                            self._FN += nb_gt - nb_pred
                            self._DE_FN += nb_gt - nb_pred
                elif gt_entry is not None:
                    loc_FN += nb_gt
                    self._FN += nb_gt
                    self._DE_FN += nb_gt
                elif pred_entry is not None:
                    loc_FP += nb_pred
                    self._FP += nb_pred
                    self._DE_FP += nb_pred
            self._S += min(loc_FP, loc_FN)
            self._D += max(0, loc_FN - loc_FP)
            self._I += max(0, loc_FP - loc_FN)
