"""Dataset loading and batching.

The port's own copy of ``seld_tpu/data/loader.py`` (numpy only), with the
same per-epoch shuffle from ``seed + epoch``, so both packages visit the
batches in the same order. It replaces the reference's pickle +
``TensorDataset``/``DataLoader`` input path (reference ``train.py:226-237``,
``train.py:438-444``):

- ``load_task2_pickles``: the six pickles, or every split of a ``.seldpak``
  container copied out of it;
- ``BatchIterator`` / ``make_loaders``: batches of in-memory arrays;
- ``PakBatchIterator`` / ``make_pak_loaders``: batches gathered out of a
  ``.seldpak`` memory map by the C++ reader (``data/native``) and normalized
  one at a time.

Host sharding: with ``num_shards`` / ``shard_id`` the batch size is the
global batch; every rank draws the same epoch order and yields its own
contiguous ``batch_size // num_shards`` rows of each global batch
(``_shard_slice``). A remainder batch that does not split evenly is skipped
on every rank, so no rank waits in a collective the others never reach.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Iterator, Optional, Tuple

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
    (predictors, targets), each {'train' | 'val' | 'test': array}. If
    ``training_predictors_path`` names a ``.seldpak`` container
    (``data/native.pack_dataset``), all six tensors come from that file,
    copied out of its memory map."""
    if str(cfg.training_predictors_path).endswith(".seldpak"):
        from seld_tpu_torch.data.native import PakReader

        predictors, targets = {}, {}
        with PakReader(cfg.training_predictors_path) as reader:
            for split in ("train", "val", "test"):
                x, y = reader.split(split)
                predictors[split], targets[split] = np.array(x), np.array(y)
        return predictors, targets
    data = {}
    for key, flag in _PATH_FLAGS.items():
        p = getattr(cfg, flag)
        if not os.path.isfile(str(p)):
            split, kind = key
            raise FileNotFoundError(
                f"dataset pickle not found: {p!r} (config --{flag}, {split} "
                f"{'predictors' if kind == 'x' else 'targets'}). Point the six "
                "--*_path flags at the L3DAS21 Task-2 pickles, pack them once into a "
                ".seldpak (seld_tpu_torch.data.native.pack_dataset), or generate a synthetic "
                "set with seld_tpu_torch.data.synthetic.gen_fake_task2_dataset."
            )
        with open(p, "rb") as f:
            data[key] = np.asarray(pickle.load(f))
    predictors = {s: data[(s, "x")] for s in ("train", "val", "test")}
    targets = {s: data[(s, "y")] for s in ("train", "val", "test")}
    return predictors, targets


def _shard_slice(idx: np.ndarray, batch_size: int, num_shards: int, shard_id: int):
    """This rank's contiguous rows of one global batch (host sharding, see
    ``parallel/multihost.py``). Full-size global batches split evenly; a
    remainder batch is kept only if it still divides (else None)."""
    if num_shards == 1:
        return idx
    if len(idx) % num_shards:
        return None
    local = len(idx) // num_shards
    return idx[shard_id * local:(shard_id + 1) * local]


class _Batches:
    """What both iterators share: the epoch order from ``seed + epoch``, the
    global batches, this rank's rows of each."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                 num_shards: int, shard_id: int):
        if batch_size % num_shards:
            raise ValueError(f"batch size {batch_size} does not split over {num_shards} shards")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.n = n
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = int(num_shards)
        self.shard_id = int(shard_id)
        self.epoch = 0

    def __len__(self) -> int:
        n, rem = divmod(self.n, self.batch_size)
        return n + (1 if rem and not self.drop_last and rem % self.num_shards == 0 else 0)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> Iterator[np.ndarray]:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = self.n - (self.n % self.batch_size) if self.drop_last else self.n
        for start in range(0, stop, self.batch_size):
            idx = _shard_slice(order[start:start + self.batch_size], self.batch_size,
                               self.num_shards, self.shard_id)
            if idx is not None:
                yield idx


class BatchIterator(_Batches):
    """Deterministic batching over in-memory arrays.

    - ``shuffle=True`` reshuffles every epoch from ``seed + epoch``.
    - yields ``(x, y)`` numpy batches; all batches have ``batch_size`` rows
      (``batch_size // num_shards`` a rank) except possibly the final
      remainder (unless ``drop_last``).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_shards: int = 1,
                 shard_id: int = 0):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} predictors but {len(y)} targets")
        super().__init__(len(x), batch_size, shuffle, seed, drop_last, num_shards, shard_id)
        self.x = x
        self.y = y

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for idx in self._indices():
            yield self.x[idx], self.y[idx]


class PakBatchIterator(_Batches):
    """:class:`BatchIterator` over a ``.seldpak`` split: each batch's rows are
    gathered out of the memory map by the C++ reader
    (``PakReader.gather``), then normalized by ``transform``; the split never
    enters memory whole."""

    def __init__(self, reader, split: str, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 num_shards: int = 1, shard_id: int = 0):
        self.reader = reader
        self.x_idx, self.y_idx = reader.SPLITS[split]
        n = reader.shape(self.x_idx)[0]
        if n != reader.shape(self.y_idx)[0]:
            raise ValueError(f"{split}: {n} predictors but {reader.shape(self.y_idx)[0]} targets")
        super().__init__(n, batch_size, shuffle, seed, drop_last, num_shards, shard_id)
        self.transform = transform

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for idx in self._indices():
            x = self.reader.gather(self.x_idx, idx)
            y = self.reader.gather(self.y_idx, idx)
            yield (self.transform(x) if self.transform is not None else x), y


def make_pak_loaders(reader, batch_size: int, seed: int = 0,
                     test_batch_size: Optional[int] = None,
                     transforms: Optional[Dict[str, Callable]] = None, num_shards: int = 1,
                     shard_id: int = 0) -> Dict[str, PakBatchIterator]:
    """Train (shuffled) / val / test loaders over a ``PakReader``, the
    counterpart of :func:`make_loaders`; ``transforms`` maps a split to its
    per-batch normalizer (``data/normalize.make_batch_transform``)."""
    transforms = transforms or {}
    shard = dict(num_shards=num_shards, shard_id=shard_id)
    return {
        "train": PakBatchIterator(reader, "train", batch_size, shuffle=True, seed=seed,
                                  transform=transforms.get("train"), **shard),
        "val": PakBatchIterator(reader, "val", batch_size, transform=transforms.get("val"),
                                **shard),
        "test": PakBatchIterator(reader, "test", test_batch_size or batch_size,
                                 transform=transforms.get("test"), **shard),
    }


def make_loaders(predictors: Dict[str, np.ndarray], targets: Dict[str, np.ndarray],
                 batch_size: int, seed: int = 0, test_batch_size: Optional[int] = None,
                 num_shards: int = 1, shard_id: int = 0) -> Dict[str, BatchIterator]:
    """Train (shuffled) / val / test loaders, mirroring reference
    train.py:442-444. The reference runs the metric pass at batch 1; the test
    loader defaults to ``batch_size`` (the metric decode is per clip anyway)."""
    tbs = test_batch_size or batch_size
    shard = dict(num_shards=num_shards, shard_id=shard_id)
    return {
        "train": BatchIterator(predictors["train"], targets["train"], batch_size, shuffle=True,
                               seed=seed, **shard),
        "val": BatchIterator(predictors["val"], targets["val"], batch_size, **shard),
        "test": BatchIterator(predictors["test"], targets["test"], tbs, **shard),
    }
