"""The port's eval SELDModel against ``model.apply(train=False)`` of the JAX
package, for the R / Q / DQ domains, with weights carried over by the
bridge.

Tiny config (``tiny_config`` below, also used by the other port tests).
Every weight, bias and BN statistic is drawn from a seeded numpy generator,
so a wrongly folded or misnamed tensor shows. Both sides run in float64
(JAX x64), so they agree to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

from seld_tpu.config import SELDConfig
from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu_torch.models.blocks import dilation_schedule, receptive_field
from seld_tpu_torch.models.seld import SELDModel, model_from_config
from seld_tpu_torch.utils.jax_bridge import from_jax_variables

F64_TOL = 1e-12


def tiny_config(**kw) -> SELDConfig:
    """F = 32, T = 32, CNN 8 / 16, one stack of 2 ResBlocks, G = U = 8, V = (16, 16)."""
    base = dict(
        domain="DQ", domain_classifier="same", input_channels=8, freq_dim=32, time_dim=32,
        cnn_filters=[8, 16], pool_size=[[2, 2], [2, 2], [2, 2]], pool_time="TCN", D=[2],
        G=8, U=8, V=[16, 16], fc_layers=[16], attention_impl="full",
        use_bias_conv=False, use_bias_linear=True,
    )
    base.update(kw)
    return SELDConfig(**base)


def random_variables(model, x_shape, rng, dtype=np.float64):
    """A variables tree with the structure of ``model.init`` (traced for its
    shapes only, nothing compiled), filled from ``rng``: weights ~ N(0,
    1/fan_in) with fan_in the product of all but the last axis, biases and BN
    means ~ N(0, 0.1^2), BN scales ~ 1 + N(0, 0.1^2), BN variances ~
    U(0.5, 1.5), so every tensor and every BN fold matters."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros(x_shape, jnp.float32), train=False),
        jax.random.PRNGKey(0),
    )

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            a = rng.uniform(0.5, 1.5, s.shape)
        elif "'scale'" in name:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif any(k in name for k in ("'mean'", "'b'", "'bias'")):
            a = 0.1 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(shapes))


@pytest.mark.parametrize("domain,classifier,bias,relu", [
    ("R", "same", False, False),
    ("Q", "R", True, True),
    ("DQ", "DQ", False, False),
    ("DQ", "same", True, True),
])
def test_seld_model_matches_jax_apply(rng, domain, classifier, bias, relu):
    cfg = tiny_config(domain=domain, domain_classifier=classifier, use_bias_conv=bias,
                      fc_activations="relu" if relu else "linear")
    x = rng.standard_normal((2, 8, 32, 32))
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, x.shape, rng)
    with enable_x64(True):
        sed_ref, doa_ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    model = model_from_config(cfg).double()
    from_jax_variables(variables, model)
    with torch.no_grad():
        sed, doa = model(torch.from_numpy(x))
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    np.testing.assert_allclose(sed.numpy(), np.asarray(sed_ref), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(doa.numpy(), np.asarray(doa_ref), rtol=0, atol=F64_TOL)


def test_flagship_schedule_and_receptive_field():
    assert dilation_schedule([10], "fibonacci") == [1, 1, 2, 3, 5, 8, 13, 21, 34, 55]
    assert dilation_schedule([4], "exponential") == [1, 2, 4, 8]
    assert dilation_schedule([[1, 3], 2], "fibonacci") == [1, 3, 1, 1]
    assert receptive_field([10], 3, "fibonacci") == (287, 10)


@pytest.mark.parametrize("kw", [dict(parallel_ConvTC_block="2Parallel", domain="Q"),
                                dict(use_se_block=True)])
def test_unported_topologies_raise(rng, kw):
    """The two topologies that raised before the port had them (2Parallel
    trunks on the channel halves, the SE block) now build and match JAX's
    ``model.apply`` in float64 (more of them: ``tests/test_torch_configs.py``)."""
    cfg = tiny_config(**kw)
    x = rng.standard_normal((2, 8, 32, 32))
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, x.shape, rng)
    with enable_x64(True):
        sed_ref, doa_ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    model = model_from_config(cfg).double()
    from_jax_variables(variables, model)
    assert isinstance(model, SELDModel) and len(model.trunks) == (
        2 if "parallel_ConvTC_block" in kw else 1)
    with torch.no_grad():
        sed, doa = model(torch.from_numpy(x))
    np.testing.assert_allclose(sed.numpy(), np.asarray(sed_ref), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(doa.numpy(), np.asarray(doa_ref), rtol=0, atol=F64_TOL)
