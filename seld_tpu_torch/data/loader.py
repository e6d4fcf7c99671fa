"""Dataset loading and batching.

The port's own copy of ``seld_tpu/data/loader.py``'s in-memory path
(``load_task2_pickles``, ``BatchIterator``, ``make_loaders``; numpy only),
with the same per-epoch shuffle from ``seed + epoch``, so both packages visit
the batches in the same order. It replaces the reference's pickle +
``TensorDataset``/``DataLoader`` input path (reference ``train.py:226-237``,
``train.py:438-444``). One process feeds one card: there is no host
sharding. The ``.seldpak`` container's native loader is not ported yet
(ROADMAP, "Next PRs": the native C++ loader) and raises.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_PATH_FLAGS = {
    ("train", "x"): "training_predictors_path",
    ("train", "y"): "training_target_path",
    ("val", "x"): "validation_predictors_path",
    ("val", "y"): "validation_target_path",
    ("test", "x"): "test_predictors_path",
    ("test", "y"): "test_target_path",
}


def load_task2_pickles(cfg) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Load the 6-pickle L3DAS21 Task-2 layout the reference trainer expects:
    (predictors, targets), each {'train' | 'val' | 'test': array}."""
    if str(cfg.training_predictors_path).endswith(".seldpak"):
        raise NotImplementedError(
            "the .seldpak container is not read by seld_tpu_torch yet (ROADMAP, Next PRs: "
            "the native C++ loader); point the six --*_path flags at the Task-2 pickles")
    data = {}
    for key, flag in _PATH_FLAGS.items():
        p = getattr(cfg, flag)
        if not os.path.isfile(str(p)):
            split, kind = key
            raise FileNotFoundError(
                f"dataset pickle not found: {p!r} (config --{flag}, {split} "
                f"{'predictors' if kind == 'x' else 'targets'}). Point the six "
                "--*_path flags at the L3DAS21 Task-2 pickles, or generate a synthetic "
                "set with seld_tpu_torch.data.synthetic.gen_fake_task2_dataset."
            )
        with open(p, "rb") as f:
            data[key] = np.asarray(pickle.load(f))
    predictors = {s: data[(s, "x")] for s in ("train", "val", "test")}
    targets = {s: data[(s, "y")] for s in ("train", "val", "test")}
    return predictors, targets


class BatchIterator:
    """Deterministic batching over in-memory arrays.

    - ``shuffle=True`` reshuffles every epoch from ``seed + epoch``.
    - yields ``(x, y)`` numpy batches; all batches have ``batch_size`` rows
      except possibly the final remainder (unless ``drop_last``).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} predictors but {len(y)} targets")
        self.x = x
        self.y = y
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n, rem = divmod(len(self.x), self.batch_size)
        return n + (1 if rem and not self.drop_last else 0)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.x)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.x[idx], self.y[idx]


def make_loaders(predictors: Dict[str, np.ndarray], targets: Dict[str, np.ndarray],
                 batch_size: int, seed: int = 0,
                 test_batch_size: Optional[int] = None) -> Dict[str, BatchIterator]:
    """Train (shuffled) / val / test loaders, mirroring reference
    train.py:442-444. The reference runs the metric pass at batch 1; the test
    loader defaults to ``batch_size`` (the metric decode is per clip anyway)."""
    tbs = test_batch_size or batch_size
    return {
        "train": BatchIterator(predictors["train"], targets["train"], batch_size, shuffle=True,
                               seed=seed),
        "val": BatchIterator(predictors["val"], targets["val"], batch_size),
        "test": BatchIterator(predictors["test"], targets["test"], tbs),
    }
