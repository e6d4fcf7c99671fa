"""JAX variables tree -> port state_dict.

The inverse direction of ``seld_tpu/utils/torch_import.py``, for the port's
own module tree: port modules carry the flax names and layouts, so a flax
leaf ``params/seld_block/cnn_0/w`` is the port tensor ``seld_block.cnn_0.w``
and ``batch_stats/.../cnn_bn_0/mean`` the buffer ``....cnn_bn_0.mean``. The
tree is given as nested dicts of numpy arrays (``jax.device_get`` of the
variables); this module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, name)
        else:
            yield name, value


def from_jax_variables(variables: Mapping, model: torch.nn.Module) -> dict:
    """Fill ``model`` from a JAX ``{'params': ..., 'batch_stats': ...}`` tree
    and return the state_dict it loaded. Raises on a JAX leaf with no port
    tensor, a shape mismatch, or a port parameter or buffer left unset.
    Values take each port tensor's dtype."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    target = model.state_dict()
    state = {}
    for collection in ("params", "batch_stats"):
        for name, value in _flatten(variables.get(collection, {})):
            if name not in target:
                raise KeyError(f"JAX leaf {collection}/{name.replace('.', '/')} maps to no "
                               "port tensor")
            arr = np.asarray(value)
            if tuple(arr.shape) != tuple(target[name].shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} != port "
                                 f"{tuple(target[name].shape)}")
            state[name] = torch.from_numpy(np.array(arr, copy=True)).to(target[name].dtype)
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"port tensors not set by the JAX tree: {missing}")
    model.load_state_dict(state)
    return state
