"""Checkpoint save / load with every random state, and the four role names.

Counterpart of ``seld_tpu/training/checkpoint.py``: the payload carries the
model (parameters and BN running statistics), the Adam state, the step
count, the dropout generator's state, the training loop's ``loop_state``
dict, the LR schedule and a numpy generator's state. Written atomically (a
temporary file, then ``os.replace``), so a crash leaves the old file whole.

The trainer keeps four roles per model directory, named as the JAX trainer
names them (reference train.py:577-616, 658-669): :data:`ROLES`. The predict
CLI reads only a checkpoint's model state (:func:`load_model_weights`).

Both loaders also read the JAX package's checkpoints, told apart by the
file's first bytes (:func:`checkpoint_format`): a ``torch.save`` zip starts
with ``PK\x03\x04``, a pickle with ``\x80``. A ``seld_tpu`` file goes
through ``training/jax_checkpoint.py`` (a restricted unpickler, no JAX)
and ``utils/jax_bridge.py::load_jax_train_state``; the port writes only its
own format.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from seld_tpu_torch.training.jax_checkpoint import read_checkpoint
from seld_tpu_torch.training.schedule import StepLRState
from seld_tpu_torch.training.steps import TrainState

FORMAT_VERSION = 1
PORT, SELD_TPU = "port", "seld_tpu"   # the two formats of checkpoint_format
# role -> file name: latest, best on validation, the previous best, best on test
ROLES = {
    "checkpoint": "checkpoint",
    "checkpoint_best": "checkpoint_best_model",
    "checkpoint_best_model_checkpoint": "checkpoint_best_model_of_checkpoint",
    "checkpoint_best_model_on_Test": "checkpoint_best_model_on_Test",
}


def save_checkpoint(path: str, state: TrainState, loop_state: Dict[str, Any],
                    sched: Optional[StepLRState] = None,
                    np_rng: Optional[np.random.Generator] = None) -> None:
    """Atomically write a checkpoint (temporary file + rename)."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "format_version": FORMAT_VERSION,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "loop_state": dict(loop_state),
        "sched": dataclasses.asdict(sched) if sched is not None else None,
        "np_rng_state": np_rng.bit_generator.state if np_rng is not None else None,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_format(path: str) -> str:
    """:data:`PORT` for a file of :func:`save_checkpoint` (a ``torch.save``
    zip), :data:`SELD_TPU` for one of the JAX package (a pickle); raises
    ``ValueError`` on anything else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return PORT
    if head[:1] == b"\x80":
        return SELD_TPU
    raise ValueError(f"{path}: neither a port checkpoint (a torch.save zip) nor a seld_tpu "
                     f"one (a pickle); it starts with {head!r}")


def _read_port(path: str) -> Dict[str, Any]:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format: {payload.get('format_version')}")
    return payload


def load_checkpoint(path: str, state: TrainState,
                    np_rng: Optional[np.random.Generator] = None
                    ) -> Tuple[TrainState, Dict[str, Any], Optional[StepLRState]]:
    """Load a checkpoint of either format into ``state`` (model, optimizer,
    step, generator) and ``np_rng`` in place; returns (state, loop_state,
    sched). A ``seld_tpu`` file carries everything but the dropout
    generator's state (``load_jax_train_state``)."""
    if checkpoint_format(path) == SELD_TPU:
        from seld_tpu_torch.utils.jax_bridge import load_jax_train_state

        payload = read_checkpoint(path)
        load_jax_train_state(payload["train_state"], state, source=path)
    else:
        payload = _read_port(path)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
    if np_rng is not None and payload["np_rng_state"] is not None:
        np_rng.bit_generator.state = payload["np_rng_state"]
    sched = StepLRState(**payload["sched"]) if payload["sched"] is not None else None
    return state, payload["loop_state"], sched


def state_shape_mismatches(expected: Mapping[str, torch.Tensor],
                           loaded: Mapping[str, torch.Tensor], max_items: int = 8) -> List[str]:
    """Readable differences between two state_dicts, the counterpart of
    ``seld_tpu/training/checkpoint.py::variable_shape_mismatches``:
    ``expected`` from the model the config builds, ``loaded`` from a
    checkpoint. [] when they fit; else 'missing' / 'unexpected' / 'shape'
    lines, at most ``max_items`` and a count of the rest."""
    e = {k: tuple(v.shape) for k, v in expected.items()}
    g = {k: tuple(v.shape) for k, v in loaded.items()}
    diffs = []
    for key in sorted(set(e) | set(g)):
        if key not in g:
            diffs.append(f"missing in checkpoint: {key} {e[key]}")
        elif key not in e:
            diffs.append(f"unexpected in checkpoint: {key} {g[key]}")
        elif e[key] != g[key]:
            diffs.append(f"shape mismatch: {key} config {e[key]} != checkpoint {g[key]}")
    if len(diffs) > max_items:
        diffs = diffs[:max_items] + [f"... and {len(diffs) - max_items} more"]
    return diffs


class CheckpointMismatch(ValueError):
    """A checkpoint's model state does not fit the model; ``diffs`` lists how."""

    def __init__(self, path: str, diffs: List[str]):
        super().__init__(f"checkpoint {path!r} does not match the model:\n  " + "\n  ".join(diffs))
        self.diffs = diffs


def load_model_weights(path: str, model: torch.nn.Module) -> None:
    """Load only the model state (parameters and BN running statistics) of a
    checkpoint of either format into ``model``, for inference; the
    optimizer, generators and loop state are not read. Raises
    :class:`CheckpointMismatch` when its names or shapes differ from the
    model's (flax paths for a ``seld_tpu`` file)."""
    if checkpoint_format(path) == SELD_TPU:
        from seld_tpu_torch.utils.jax_bridge import from_jax_variables, variable_mismatches

        tree = read_checkpoint(path)["train_state"]
        variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
        diffs = variable_mismatches(variables, model)
        if diffs:
            raise CheckpointMismatch(path, diffs)
        from_jax_variables(variables, model)
        return
    state = _read_port(path)["model"]
    diffs = state_shape_mismatches(model.state_dict(), state)
    if diffs:
        raise CheckpointMismatch(path, diffs)
    model.load_state_dict(state)


def archive_checkpoints(model_dir: str, epoch: int, files: Dict[str, str]) -> str:
    """Copy the given role -> file checkpoints into ``checkpoint_epoch_<epoch>``
    under ``model_dir`` as ``<role>_epoch_<epoch>`` (reference
    train.py:676-688); returns the directory."""
    archive_dir = os.path.join(model_dir, f"checkpoint_epoch_{epoch}")
    os.makedirs(archive_dir, exist_ok=True)
    for tag, src in files.items():
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(archive_dir, f"{tag}_epoch_{epoch}"))
    return archive_dir
