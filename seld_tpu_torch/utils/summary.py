"""Model introspection: per-module parameter table + model-name breakdown.

The port's counterpart of ``seld_tpu/utils/summary.py``. ``model_summary``
stands in for the reference's ``torchinfo.summary`` call (reference
train.py:483): parameter counts from ``named_parameters()``, grouped at the
module level. Parameter names keep the JAX package's paths with '/' for '.'
(``seld_block/cnn_0``), so the two packages print the same table.
``describe_model_name`` mirrors ``print_model_name`` (reference
model.py:519-546): it labels each field of the synthesized model name
(``models/seld.py::synthesize_model_name``).
"""

from __future__ import annotations

from typing import List, Tuple

from torch import nn


def summarize_params(model: nn.Module) -> Tuple[List[Tuple[str, str, int]], int]:
    """(rows, total): one row per parameter — (path, shape, count)."""
    rows = []
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        rows.append((name.replace(".", "/"), "x".join(map(str, p.shape)) or "scalar", n))
        total += n
    return rows, total


def model_summary(model: nn.Module, depth: int = 2) -> str:
    """Formatted per-module parameter table; rows aggregate over parameter
    paths cut to ``depth`` components (depth=2 groups e.g.
    ``seld_block/cnn_0``)."""
    rows, total = summarize_params(model)
    groups: dict = {}
    for name, _, n in rows:
        key = "/".join(name.split("/")[:depth])
        count = groups.setdefault(key, [0, 0])
        count[0] += n
        count[1] += 1
    width = max((len(k) for k in groups), default=10)
    lines = [f"{'module':<{width}}  {'params':>12}  tensors", "-" * (width + 24)]
    lines += [f"{key:<{width}}  {n:>12,}  {cnt}" for key, (n, cnt) in groups.items()]
    lines += ["-" * (width + 24), f"{'TOTAL':<{width}}  {total:>12,}  {len(rows)}"]
    return "\n".join(lines)


def describe_model_name(model_name: str) -> List[str]:
    """Label the fields encoded in a synthesized model name (underscore-joined,
    e.g. ``QSELD-TCN-PHI-S1_BN_RF287_10RB``); unknown parts are labeled
    'extra', the reference's fallback branch (model.py:545-546)."""
    out = []
    for part in model_name.split("_"):
        if part.startswith(("QSELD", "DualQSELD", "SELD", "2Parallel")):
            out.append(f"model family: {part}")
        elif part in {"BN", "noBN", "BNonCNN", "BNonTCN"} or part.startswith("BN_on"):
            out.append(f"batch-norm type: {part}")
        elif part.startswith("RF"):
            out.append(f"receptive field: {part[2:]}")
        elif part.endswith("RB"):
            out.append(f"ResBlocks: {part[:-2]}")
        elif part.startswith("poolt"):
            out.append(f"time pooling: {part[5:]}")
        else:
            out.append(f"extra: {part}")
    return out
