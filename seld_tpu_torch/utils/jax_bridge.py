"""JAX variables tree <-> port state_dict.

The inverse direction of ``seld_tpu/utils/torch_import.py``, for the port's
own module tree: port modules carry the flax names and layouts, so a flax
leaf ``params/seld_block/cnn_0/w`` is the port tensor ``seld_block.cnn_0.w``
and ``batch_stats/.../cnn_bn_0/mean`` the buffer ``....cnn_bn_0.mean``. The
tree is given as nested dicts of numpy arrays (``jax.device_get`` of the
variables); this module imports no JAX. :func:`to_jax_variables` walks the
other way, for comparing a port model after training steps with the JAX
package's ``TrainState.params`` / ``.batch_stats``.
:func:`load_jax_train_state` carries a whole JAX train state, as
``training/jax_checkpoint.py`` reads it from a ``seld_tpu`` checkpoint,
into a port ``TrainState``: the model, the Adam state, the step count, the
learning rate and the dropout generator's seed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from seld_tpu_torch.training.checkpoint import CheckpointMismatch, state_shape_mismatches
from seld_tpu_torch.training.jax_checkpoint import adam_state


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


def to_jax_variables(model: torch.nn.Module) -> dict:
    """``{'params': ..., 'batch_stats': ...}`` nested dicts of numpy arrays
    from ``model``: parameters go to ``params``, buffers (the BN running
    statistics) to ``batch_stats``, each at its flax path."""
    tree: dict = {"params": {}, "batch_stats": {}}
    buffers = {name for name, _ in model.named_buffers()}
    for name, tensor in model.state_dict().items():
        node = tree["batch_stats" if name in buffers else "params"]
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = tensor.detach().cpu().numpy().copy()
    return tree


def _flax_paths(tree: Mapping, collection: str) -> dict:
    return {f"{collection}/{name.replace('.', '/')}": np.asarray(value)
            for name, value in _flatten(tree)}


def variable_mismatches(variables: Mapping, model: torch.nn.Module) -> list:
    """``training/checkpoint.py::state_shape_mismatches`` of a JAX
    ``{'params', 'batch_stats'}`` tree against ``model``, every line naming
    a flax path (``params/seld_block/cnn_0/w``); [] when they fit."""
    buffers = {name for name, _ in model.named_buffers()}
    expected = {f"{'batch_stats' if name in buffers else 'params'}/{name.replace('.', '/')}": t
                for name, t in model.state_dict().items()}
    loaded = {}
    for collection, tree in variables.items():
        loaded.update(_flax_paths(tree, str(collection)))
    return state_shape_mismatches(expected, loaded)


def load_jax_train_state(train_state: Mapping, state, source: str = "<JAX train state>"):
    """Fill the port ``TrainState`` ``state`` from a JAX train state given as
    nested dicts of numpy arrays (``training/jax_checkpoint.py``'s
    ``read_checkpoint(...)['train_state']``); returns ``state``.

    - ``params`` and ``batch_stats`` go into ``state.model`` through
      :func:`from_jax_variables`;
    - optax's Adam ``mu`` / ``nu`` at each parameter's flax path become that
      parameter's torch ``exp_avg`` / ``exp_avg_sq``, matched by name through
      ``named_parameters()``, and its ``count`` torch's ``step`` (a float32
      scalar tensor): the same update, since both divide the moments by
      ``1 - beta ** count``;
    - the injected hyperparameters give the learning rate, the betas and
      eps (optax's ``eps_root`` must be 0: torch's Adam has none);
    - ``step`` becomes ``state.step``;
    - the dropout generator is seeded from the PRNG key's two words.

    The dropout masks of JAX (``fold_in(rng, step)`` through JAX's
    generator) cannot be drawn in torch, so a resumed run draws other masks:
    that is the one piece of state that does not carry over. Raises
    ``training.checkpoint.CheckpointMismatch``, with flax paths, where a
    parameter or moment is missing on either side or its shape differs.
    Values take each port tensor's dtype and device."""
    model, optimizer = state.model, state.optimizer
    variables = {"params": train_state["params"], "batch_stats": train_state["batch_stats"]}
    adam = adam_state(train_state["opt_state"])
    params = _flax_paths(train_state["params"], "params")
    moments = {m: _flax_paths(adam[m], "params") for m in ("mu", "nu")}
    diffs = variable_mismatches(variables, model) + [
        f"Adam {m}: {line}" for m, tree in moments.items()
        for line in state_shape_mismatches(params, tree)]
    if diffs:
        raise CheckpointMismatch(source, diffs)
    from_jax_variables(variables, model)

    hyper = {k: float(np.asarray(v)) for k, v in train_state["opt_state"]["hyperparams"].items()}
    if hyper.get("eps_root", 0.0) != 0.0:
        raise ValueError(f"{source}: optax eps_root {hyper['eps_root']} has no torch Adam "
                         "counterpart")
    count = float(np.asarray(adam["count"]))
    name_of = {id(p): f"params/{name.replace('.', '/')}" for name, p in model.named_parameters()}
    sd = optimizer.state_dict()
    sd["state"] = {}
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        for p, index in zip(group["params"], saved["params"]):
            path = name_of[id(p)]
            sd["state"][index] = {"step": torch.tensor(count, dtype=torch.float32),
                                  "exp_avg": torch.from_numpy(np.array(moments["mu"][path])),
                                  "exp_avg_sq": torch.from_numpy(np.array(moments["nu"][path]))}
        saved["lr"] = hyper["learning_rate"]
        saved["betas"] = (hyper["b1"], hyper["b2"])
        saved["eps"] = hyper["eps"]
    optimizer.load_state_dict(sd)   # casts the moments to each parameter's dtype and device
    state.step = int(np.asarray(train_state["step"]))
    key = np.asarray(train_state["rng"]).astype(np.uint64)   # uint32[2]
    state.generator.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
    return state
