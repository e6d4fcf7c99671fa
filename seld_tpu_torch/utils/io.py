"""Small host-side IO helpers (the port's own copy of ``seld_tpu/utils/io.py``)."""

from __future__ import annotations

from typing import Iterable

import numpy as np


def save_array_to_csv(file_name: str, array_to_save: Iterable) -> None:
    """Append one row of floats to a CSV, opening/closing per call so the file
    survives crashes (reference utility_functions.py:96-109 semantics)."""
    with open(file_name, "a") as f:
        f.write(",".join("%f" % float(v) for v in array_to_save) + "\n")


def write_submission_csv(path: str, events) -> None:
    """Write decoded events ((N, 5) rows of [frame, class, x, y, z]) as a
    headerless CSV, each value as Python's shortest repr of its float: the
    bytes ``pd.DataFrame(events).to_csv(path, index=None, header=None)``
    writes for float64 events (the JAX predict CLI's), without pandas. No
    events give an empty file."""
    rows = np.asarray(events, dtype=np.float64).reshape(-1, 5)
    with open(path, "w") as f:
        f.writelines(",".join(repr(float(v)) for v in row) + "\n" for row in rows)
