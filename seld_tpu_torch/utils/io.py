"""Small host-side IO helpers (the port's own copy of ``seld_tpu/utils/io.py``)."""

from __future__ import annotations

from typing import Iterable


def save_array_to_csv(file_name: str, array_to_save: Iterable) -> None:
    """Append one row of floats to a CSV, opening/closing per call so the file
    survives crashes (reference utility_functions.py:96-109 semantics)."""
    with open(file_name, "a") as f:
        f.write(",".join("%f" % float(v) for v in array_to_save) + "\n")
