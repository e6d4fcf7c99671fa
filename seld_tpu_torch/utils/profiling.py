"""Step timing and a JSONL metrics log.

The port's counterpart of ``seld_tpu/utils/profiling.py``:

- :class:`StepTimer` — per-step wall-clock statistics with warm-up steps
  skipped; on a CUDA device it synchronizes the card before reading the
  clock, so a step's time includes its kernels (PyTorch returns before the
  device finishes).
- :class:`MetricsLogger` — append-only JSONL metrics log (one flat dict per
  line).
- :func:`device_events` — the device kernels of one call by
  ``torch.profiler``, each capture checked whole by two bracketing kernels
  (the card's own; no JAX counterpart).
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

# torch.cuda._sleep's kernel, launched before and after the call a capture
# holds (device_events); BRACKET_CYCLES spins a few microseconds; a first
# capture's leading brackets, doubled on each retake
BRACKET_KERNEL = "spin_kernel"
BRACKET_CYCLES = 10_000
LEAD_BRACKETS = 4
CAPTURE_TRIES = 5
# device_events' captures this process: "whole" and "retaken"
CAPTURES: Counter = Counter()


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


def device_events(run, cpu: bool = False):
    """``run()`` once under ``torch.profiler`` on the card: returns its device
    events (``key_averages()``'s, by kernel name) and its wall milliseconds.

    On the H100 the profiler left out the first one or two kernels of every
    capture for stretches of a run (all of a one-kernel call's, K1 of a
    serving request), whatever the host waited first. So the call comes
    after LEAD_BRACKETS ``torch.cuda._sleep`` kernels (the leading brackets)
    and before one more (the trailing bracket), with a synchronize after
    each group; the capture is whole only where its first and its last
    device event, in time, are brackets. Else it is taken again with twice
    the leading brackets, ``run()`` once more, at most CAPTURE_TRIES
    captures in all, and then this raises. The brackets are left out of the events.
    ``cpu`` records host activities too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    seen = []
    for attempt in range(CAPTURE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(LEAD_BRACKETS * 2 ** attempt):
                torch.cuda._sleep(BRACKET_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(BRACKET_CYCLES)
            torch.cuda.synchronize()
        order = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.time_range.start)
        if order and all(BRACKET_KERNEL in e.name for e in (order[0], order[-1])):
            CAPTURES["whole"] += 1
            return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                    and BRACKET_KERNEL not in e.key], wall_ms
        CAPTURES["retaken"] += 1
        seen.append(f"{len(order)} device events" + (
            f", first {order[0].name[:48]}, last {order[-1].name[:48]}" if order else ""))
    raise RuntimeError(f"torch.profiler recorded no whole capture in {CAPTURE_TRIES} tries: "
                       + "; ".join(seen))
