"""The JAX -> port weight bridge: every leaf of a JAX SELDModel's variables
maps to one port tensor of the same shape, every port parameter and buffer
is set, and a tree that does not fit raises."""

import copy

import numpy as np
import pytest

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.test_torch_model import random_variables, tiny_config


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


@pytest.mark.parametrize("domain,classifier,bias", [("DQ", "DQ", False), ("Q", "R", True),
                                                    ("R", "same", True)])
def test_every_leaf_maps_and_every_tensor_is_set(rng, domain, classifier, bias):
    cfg = tiny_config(domain=domain, domain_classifier=classifier, use_bias_conv=bias)
    variables = random_variables(jax_model_from_config(cfg), (1, 8, 32, 32), rng,
                                 dtype=np.float32)
    model = model_from_config(cfg)
    state = from_jax_variables(variables, model)
    jax_leaves = dict(_leaves(variables["params"]))
    jax_leaves.update(_leaves(variables["batch_stats"]))
    assert set(state) == set(jax_leaves) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        np.testing.assert_array_equal(tensor.numpy(), jax_leaves[name])
    n_buffers = sum(1 for _ in model.buffers())
    assert n_buffers == len(dict(_leaves(variables["batch_stats"]))) > 0


def _variables(rng):
    cfg = tiny_config()
    return cfg, random_variables(jax_model_from_config(cfg), (1, 8, 32, 32), rng,
                                 dtype=np.float32)


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "bad_shape", "collection"])
def test_bridge_rejects_trees_that_do_not_fit(rng, fault):
    cfg, variables = _variables(rng)
    variables = copy.deepcopy(variables)
    if fault == "extra_leaf":
        variables["params"]["seld_block"]["tcn"]["resblock_0"]["batch_gate1"] = {
            "scale": np.ones(8, np.float32)}
    elif fault == "missing_leaf":
        del variables["batch_stats"]["seld_block"]["cnn_bn_0"]["var"]
    elif fault == "bad_shape":
        variables["params"]["sed_out"]["kernel"] = np.zeros((3, 3), np.float32)
    else:
        variables["dropout"] = {}
    with pytest.raises((KeyError, ValueError)):
        from_jax_variables(variables, model_from_config(cfg))
