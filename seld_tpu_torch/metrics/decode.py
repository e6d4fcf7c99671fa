"""Decode (sed, doa) model outputs into event lists.

The port's own copy of ``seld_tpu/metrics/decode.py`` (numpy only).
Vectorized equivalent of the reference's per-frame loop
(``utility_functions.py:184-210``): threshold SED at 0.5, rescale DOA by
``max_loc_value``, and emit one ``[frame, class, x, y, z]`` row per active
(class, overlap-slot) plus the frame-keyed dict the DCASE21 metrics consume.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def gen_submission_list_task2(
    sed: np.ndarray,
    doa: np.ndarray,
    max_loc_value: float = 2.0,
    num_frames: int = 600,
    num_classes: int = 14,
    max_overlaps: int = 3,
) -> Tuple[np.ndarray, Dict[int, list]]:
    """sed: (T, classes*overlaps), doa: (T, classes*overlaps*3).

    Returns (event array (N, 5), frame dict {frame: [[class, x, y, z, slot]]}).
    """
    sed = np.asarray(sed)
    doa = np.asarray(doa)
    T = sed.shape[0]
    active = np.round(sed).astype(bool)  # threshold at 0.5
    loc = (doa * max_loc_value).reshape(T, num_classes, max_overlaps, 3)

    frames, flat_idx = np.nonzero(active)
    classes = flat_idx // max_overlaps
    slots = flat_idx % max_overlaps
    coords = loc[frames, classes, slots]

    output = np.column_stack(
        [frames.astype(np.float64), classes.astype(np.float64), coords]
    ) if len(frames) else np.empty((0,))

    output_dict: Dict[int, list] = {}
    for f, c, s, xyz in zip(frames, classes, slots, coords):
        output_dict.setdefault(int(f), []).append(
            [int(c), float(xyz[0]), float(xyz[1]), float(xyz[2]), int(s)]
        )
    return output, output_dict
