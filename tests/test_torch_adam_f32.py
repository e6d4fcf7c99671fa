"""Adam's hyperparameters in float32: the port against the JAX package with
x64 off.

Without x64 the JAX step's ``optax.inject_hyperparams`` holds b1, b2 and eps
as float32 arrays (``seld_tpu/training/steps.py:38``): b2 reads back as
0.9990000129, so 1 - b2 sits 1.29e-5 from 1e-3. The port's ``make_optimizer``
passes Python floats. Two checks, each with the Python betas and with
``float(np.float32(.))`` ones:

- the optimizer alone: torch's Adam and optax's float32 Adam on the same
  twenty random float32 gradients, from zero parameters (so parameter
  rounding does not hide the update's arithmetic);
- a few float32 train steps of a tiny model against JAX's
  ``make_train_step`` from the same weights.

Finding (printed by ``-s``): the optimizer alone sits 6.41e-7 from optax
with the Python betas and 6.54e-7 with the float32 ones; four steps 1.26e-5
and 1.19e-5 of the JAX update. Neither choice is closer beyond the float32
rounding of the rest (the bias corrections cancel most of 1 - b2's change),
so the port keeps the Python betas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.training.steps import TrainState as JaxTrainState
from seld_tpu.training.steps import make_optimizer as jax_make_optimizer
from seld_tpu.training.steps import make_train_step as jax_make_train_step
from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data.synthetic import make_task2_batch
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.training.steps import TrainState, make_optimizer, make_train_step
from seld_tpu_torch.utils.jax_bridge import from_jax_variables, to_jax_variables

BETAS = {"python": (0.9, 0.999),
         "float32": (float(np.float32(0.9)), float(np.float32(0.999)))}
OPT_TOL = 5e-6    # relative distance from optax's float32 Adam after 20 updates
STEP_TOL = 2e-5   # relative to the JAX step's parameter update, after STEPS steps
SPREAD = 0.1      # the optimizer alone: the two betas' distances differ by at most this share
STEP_SPREAD = 0.25   # a whole step: its float32 rounding reaches the update too
STEPS, LR = 4, 1e-3


def _relative(got, want, base) -> float:
    num = sum(float(((g.astype(np.float64) - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float(((w.astype(np.float64) - b) ** 2).sum()) for w, b in zip(want, base))
    return float(np.sqrt(num / den))


def test_make_optimizer_takes_the_python_betas():
    group = make_optimizer([torch.zeros(1, requires_grad=True)], LR).param_groups[0]
    assert group["betas"] == BETAS["python"] and group["eps"] == 1e-8


@pytest.fixture(scope="module")
def optimizer_distances():
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (128,), (16, 16, 8)]
    grads = [[(rng.standard_normal(s) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
              for s in shapes] for _ in range(20)]
    zero = [np.zeros(s, np.float32) for s in shapes]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR, b1=0.9, b2=0.999, eps=1e-8)
    params = [jnp.asarray(p) for p in zero]
    opt_state = tx.init(params)
    assert opt_state.hyperparams["b2"].dtype == jnp.float32
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, params)
        params = optax.apply_updates(params, updates)
    want = [np.asarray(p) for p in params]
    out = {}
    for name, betas in BETAS.items():
        tp = [torch.zeros(s, requires_grad=True) for s in shapes]
        opt = torch.optim.Adam(tp, lr=LR, betas=betas, eps=1e-8)
        for g in grads:
            for t, x in zip(tp, g):
                t.grad = torch.from_numpy(x)
            opt.step()
        out[name] = _relative([t.detach().numpy() for t in tp], want, zero)
    return out


@pytest.mark.parametrize("name", list(BETAS))
def test_the_optimizer_alone_against_optax_float32(optimizer_distances, name):
    d = optimizer_distances
    print(f"[adam f32] optimizer alone, {name} betas: {d[name]:.3e} from optax float32")
    assert d[name] <= OPT_TOL
    assert abs(d["python"] - d["float32"]) <= SPREAD * d["python"]


def _cfg() -> SELDConfig:
    return SELDConfig(domain="Q", input_channels=8, freq_dim=16, time_dim=16,
                      cnn_filters=[8, 8], pool_size=[[2, 2], [2, 2], [2, 2]], pool_time="TCN",
                      D=[1], G=8, U=8, V=[8, 8], fc_layers=[8], attention_impl="full",
                      use_bias_conv=False, dropout_perc=0.0, spatial_dropout_rate=0.0, lr=LR,
                      frontend_impl="xla")


@pytest.fixture(scope="module")
def step_distances():
    from seld_tpu.config import SELDConfig as JaxSELDConfig

    cfg = _cfg()
    jcfg = JaxSELDConfig(**{k: getattr(cfg, k) for k in SELDConfig.field_names()
                            if k in JaxSELDConfig.field_names()})
    x, y = make_task2_batch(np.random.default_rng(1), 2, channels=8, freq=16, time_frames=16,
                            label_frames=2)
    init = model_from_config(cfg, generator=torch.Generator().manual_seed(0))
    base = {k: v.numpy().copy() for k, v in init.state_dict().items()}
    variables = to_jax_variables(init)
    assert not jax.config.jax_enable_x64
    tx = jax_make_optimizer(LR)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                           variables["batch_stats"]),
        opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    step = jax_make_train_step(jax_model_from_config(jcfg), tx, jcfg)
    for _ in range(STEPS):
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    jmodel = model_from_config(cfg)
    from_jax_variables(jax.device_get({"params": state.params,
                                       "batch_stats": state.batch_stats}), jmodel)
    names = [n for n, _ in init.named_parameters()]
    want = [jmodel.state_dict()[n].numpy() for n in names]
    out = {}
    for name, betas in BETAS.items():
        model = model_from_config(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in base.items()})
        opt = torch.optim.Adam(model.parameters(), lr=LR, betas=betas, eps=1e-8)
        pstate = TrainState(model, opt, torch.Generator().manual_seed(0))
        pstep = make_train_step(cfg)
        for _ in range(STEPS):
            pstate, _ = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        got = [model.state_dict()[n].numpy() for n in names]
        out[name] = _relative(got, want, [base[n] for n in names])
    return out


@pytest.mark.parametrize("name", list(BETAS))
def test_float32_steps_against_the_jax_step(step_distances, name):
    d = step_distances
    print(f"[adam f32] {STEPS} steps, {name} betas: {d[name]:.3e} of the JAX update")
    assert d[name] <= STEP_TOL
    assert abs(d["python"] - d["float32"]) <= STEP_SPREAD * d["python"]
