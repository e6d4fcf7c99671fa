"""Read ``seld_tpu`` checkpoints without JAX.

The JAX package writes a checkpoint as a pickle of a host copy of its train
state (``seld_tpu/training/checkpoint.py::save_checkpoint``): a dict
``{format_version, train_state, loop_state, sched, np_rng_state}`` whose
``train_state`` is a flax ``TrainState`` (``step, params, batch_stats,
opt_state, rng``) with an optax state inside. Unpickling it the usual way
imports ``seld_tpu``, ``flax`` and ``optax``; the card's host has none of
them.

:func:`read_checkpoint` unpickles it with :class:`RestrictedUnpickler`,
whose ``find_class`` resolves an explicit allowlist and nothing else: the
JAX package's classes map to small stand-ins of this module, numpy's array
and dtype reconstructors to numpy's own. Any other global raises an
``UnpicklingError`` that names it, before anything of it is imported or
called, so the reader is also safe on a file of unknown origin. The result
is plain nested dicts of numpy arrays:

    {"train_state": {"step", "params", "batch_stats", "rng",
                     "opt_state": {"count", "hyperparams", "hyperparams_states",
                                   "inner_state": ({"count", "mu", "nu"}, {})}},
     "loop_state": {...}, "sched": {...} or None, "np_rng_state": {...} or None}

Every leaf keeps the dtype it was written with. ``hyperparams_states`` is
absent in files of optax versions before its ``InjectStatefulHyperparamsState``.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, NamedTuple

import numpy as np

FORMAT_VERSION = 1


class _TrainState:
    """Stand-in of ``seld_tpu.training.steps.TrainState``, a flax struct
    dataclass: pickled as NEWOBJ with no arguments, then BUILD with its
    field dict."""

    FIELDS = ("step", "params", "batch_stats", "opt_state", "rng")

    def __setstate__(self, state):
        if not isinstance(state, dict) or set(state) != set(self.FIELDS):
            raise pickle.UnpicklingError(
                f"TrainState: expected the fields {self.FIELDS}, got "
                f"{sorted(state) if isinstance(state, dict) else type(state).__name__}")
        self.fields = state


# the optax NamedTuples, each pickled as NEWOBJ with its fields as arguments
class _ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class _EmptyState(NamedTuple):
    pass


class _InjectStatefulHyperparamsState(NamedTuple):
    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


class _InjectHyperparamsState(NamedTuple):   # optax before 0.1.9
    count: Any
    hyperparams: Any
    inner_state: Any


def _numpy_attr(modules, name):
    """``name`` of the first of ``modules`` that this numpy has (numpy 2
    moved ``numpy.core`` to ``numpy._core``)."""
    import importlib

    for module in modules:
        try:
            return getattr(importlib.import_module(module), name)
        except (ImportError, AttributeError):
            continue
    raise pickle.UnpicklingError(f"numpy has no {name} in {modules}")


_NUMERIC = ("numpy._core.numeric", "numpy.core.numeric")
_MULTIARRAY = ("numpy._core.multiarray", "numpy.core.multiarray")

# (module, name) -> what it resolves to (a callable: resolved on first use). The
# JAX package's save_checkpoint names the first four classes, numpy.dtype and
# numpy's _frombuffer; a host with numpy 1.x names numpy.core's reconstructors
ALLOWED = {
    ("seld_tpu.training.steps", "TrainState"): _TrainState,
    ("optax._src.transform", "ScaleByAdamState"): _ScaleByAdamState,
    ("optax._src.base", "EmptyState"): _EmptyState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        _InjectStatefulHyperparamsState,
    ("optax.schedules._inject", "InjectHyperparamsState"): _InjectHyperparamsState,
    ("optax._src.schedule", "InjectHyperparamsState"): _InjectHyperparamsState,
    ("numpy", "dtype"): np.dtype,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy._core.numeric", "_frombuffer"): lambda: _numpy_attr(_NUMERIC, "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"): lambda: _numpy_attr(_NUMERIC, "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"):
        lambda: _numpy_attr(_MULTIARRAY, "_reconstruct"),
}


class RestrictedUnpickler(pickle.Unpickler):
    """Resolves only the globals of :data:`ALLOWED`; any other raises."""

    def find_class(self, module, name):
        try:
            found = ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"refused global {module}.{name}: a seld_tpu checkpoint holds only "
                f"{sorted(f'{m}.{n}' for m, n in ALLOWED)}") from None
        return found if isinstance(found, type) else found()

    def persistent_load(self, pid):
        raise pickle.UnpicklingError("a seld_tpu checkpoint holds no persistent ids")


def _plain(obj):
    """Stand-ins -> dicts, tuples of them -> tuples; numpy arrays as they are."""
    if isinstance(obj, _TrainState):
        return {k: _plain(v) for k, v in obj.fields.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: _plain(getattr(obj, k)) for k in obj._fields}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, np.ndarray) and obj.dtype.hasobject:
        raise pickle.UnpicklingError("a seld_tpu checkpoint holds no object arrays")
    return obj


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of the ``seld_tpu`` checkpoint at ``path`` as plain
    nested dicts of numpy arrays (see the module docstring). Raises
    ``pickle.UnpicklingError`` on a global outside the allowlist and
    ``ValueError`` on a ``format_version`` other than 1."""
    with open(path, "rb") as f:
        payload = RestrictedUnpickler(f).load()
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: not a seld_tpu checkpoint (a {type(payload).__name__})")
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format: {payload.get('format_version')}")
    if not isinstance(payload.get("train_state"), _TrainState):
        raise ValueError(f"{path}: its train_state is not a seld_tpu TrainState")
    return {k: _plain(payload.get(k)) for k in
            ("train_state", "loop_state", "sched", "np_rng_state")}


def adam_state(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The ``{'count', 'mu', 'nu'}`` of the Adam transform inside an
    injected-hyperparameter optax state (as :func:`read_checkpoint` gives it)."""
    found = [s for s in opt_state["inner_state"] if isinstance(s, dict) and {"mu", "nu"} <= set(s)]
    if len(found) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, found {len(found)}")
    return found[0]
