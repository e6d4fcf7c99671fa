"""Step timing and a JSONL metrics log.

The port's counterpart of ``seld_tpu/utils/profiling.py``:

- :class:`StepTimer` — per-step wall-clock statistics with warm-up steps
  skipped; on a CUDA device it synchronizes the card before reading the
  clock, so a step's time includes its kernels (PyTorch returns before the
  device finishes).
- :class:`MetricsLogger` — append-only JSONL metrics log (one flat dict per
  line).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Wall-clock step timing with warm-up exclusion; ``device`` (a CUDA
    device) is synchronized on entry and exit."""

    def __init__(self, warmup_steps: int = 2, device=None):
        self.warmup_steps = warmup_steps
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup_steps:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.times else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        return {"steps": len(ts), "mean_s": self.mean, "p50_s": ts[len(ts) // 2],
                "max_s": ts[-1], "steps_per_sec": self.steps_per_sec}


class MetricsLogger:
    """Crash-safe JSONL metrics log (one flat dict per line)."""

    def __init__(self, path: str):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
