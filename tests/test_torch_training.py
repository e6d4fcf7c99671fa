"""The port's training slice against the JAX package, on the CPU.

- the whole slice: three ``make_train_step`` steps of a tiny DQ model in
  float64 with dropout off, against ``seld_tpu.training.steps.make_train_step``
  on bridged weights: losses and updated parameters and BN statistics within
  1e-9 relative; the same with ``grad_accum_steps=2`` and BN on;
- train-mode BatchNorm (batch statistics, running statistics with the
  unbiased variance) against the JAX BatchNorm, float64, 1e-12;
- gradient accumulation against the full batch with BN and dropout off;
- dropout masks; the K5 and flash ops inside the model against the plain
  stage and full attention; the loss, StepLR and a checkpoint round trip.

The tiny config and the random variables come from ``tests/test_torch_model``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.models.layers import BatchNorm as JaxBatchNorm
from seld_tpu.training.loss import seld_loss as jax_seld_loss
from seld_tpu.training.schedule import StepLRState as JaxStepLR
from seld_tpu.training.steps import TrainState as JaxTrainState
from seld_tpu.training.steps import make_optimizer as jax_make_optimizer
from seld_tpu.training.steps import make_train_step as jax_make_train_step
from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data.synthetic import make_task2_batch
from seld_tpu_torch.models.layers import BatchNorm, SpatialDropout1D
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.training import (
    StepLRState, create_train_state, load_checkpoint, make_eval_step, make_train_step,
    save_checkpoint, seld_loss, set_learning_rate,
)
from seld_tpu_torch.utils.jax_bridge import from_jax_variables, to_jax_variables
from tests.test_torch_model import random_variables, tiny_config

F64_TOL = 1e-9


def _cfg(**kw):
    """The tiny model with dropout off, lr 1e-3 (updates well above rounding)."""
    base = dict(dropout_perc=0.0, spatial_dropout_rate=0.0, lr=1e-3)
    base.update(kw)
    return tiny_config(**base)


def _port_cfg(cfg) -> SELDConfig:
    """The same settings in the port's own config class."""
    return SELDConfig(**{k: getattr(cfg, k) for k in SELDConfig.field_names()})


def _batch(rng, b, dtype=np.float64):
    x, y = make_task2_batch(rng, b, channels=8, freq=32, time_frames=32, label_frames=4)
    return x.astype(dtype), y.astype(dtype)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def _assert_trees_close(got, want, tol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def _run_both(cfg, variables, x, y, steps):
    """``steps`` train steps of the JAX package and of the port, float64,
    from the same variables; returns (jax losses, jax state, port losses,
    port model)."""
    with enable_x64(True):
        jmodel = jax_model_from_config(cfg)
        tx = jax_make_optimizer(cfg.lr)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                  variables["batch_stats"]),
                               opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        jstep = jax_make_train_step(jmodel, tx, cfg)
        jlosses = []
        for _ in range(steps):
            jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
            jlosses.append(float(loss))
        jstate = jax.device_get(jstate)
    pcfg = _port_cfg(cfg)
    model = model_from_config(pcfg).double()
    from_jax_variables(variables, model)
    state = create_train_state(model, pcfg, torch.Generator().manual_seed(0))
    step = make_train_step(pcfg)
    plosses = []
    for _ in range(steps):
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y))
        plosses.append(float(loss))
    assert state.step == steps
    return jlosses, jstate, plosses, model


@pytest.mark.parametrize("kw", [dict(), dict(grad_accum_steps=2, batch_size=4)],
                         ids=["full_batch", "grad_accum"])
def test_train_steps_match_jax(rng, kw):
    cfg = _cfg(**kw)
    x, y = _batch(rng, cfg.batch_size if kw else 2)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng)
    jlosses, jstate, plosses, model = _run_both(cfg, variables, x, y, steps=3)
    np.testing.assert_allclose(plosses, jlosses, rtol=F64_TOL)
    assert plosses[-1] < plosses[0]
    tree = to_jax_variables(model)
    _assert_trees_close(tree["params"], jstate.params, F64_TOL)
    _assert_trees_close(tree["batch_stats"], jstate.batch_stats, F64_TOL)


def test_train_mode_batchnorm_matches_jax(rng):
    x = rng.standard_normal((3, 7, 5)) * 2 + 0.5
    variables = {"params": {"scale": 1 + 0.1 * rng.standard_normal(5),
                            "bias": 0.1 * rng.standard_normal(5)},
                 "batch_stats": {"mean": 0.1 * rng.standard_normal(5),
                                 "var": rng.uniform(0.5, 1.5, 5)}}
    with enable_x64(True):
        want, upd = JaxBatchNorm().apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                         jnp.asarray(x), use_running_average=False,
                                         mutable=["batch_stats"])
    bn = BatchNorm(5).double()
    from_jax_variables(variables, bn)
    got = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-12)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-12)
    # running var: retention 0.9 and torch's unbiased var * n / (n - 1), n = 21
    n = 21
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * variables["batch_stats"]["var"]
                               + 0.1 * x.reshape(n, 5).var(0) * n / (n - 1), atol=1e-12)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-12)


def test_grad_accum_matches_full_batch(rng):
    """With BN and dropout off, two microbatches reproduce the full-batch step
    (the gradient of a mean is linear), as tests/test_training.py checks for
    the JAX package."""
    pcfg = _port_cfg(_cfg(batch_norm="None", batch_size=4))
    x, y = (torch.from_numpy(a) for a in _batch(rng, 4))
    torch.manual_seed(0)
    model0 = model_from_config(pcfg, generator=torch.Generator().manual_seed(1)).double()
    results = []
    for accum in (1, 2):
        model = model_from_config(pcfg).double()
        model.load_state_dict(model0.state_dict())
        cfg = pcfg.replace(grad_accum_steps=accum)
        state = create_train_state(model, cfg, torch.Generator().manual_seed(0))
        state, loss = make_train_step(cfg)(state, x, y)
        results.append((float(loss), model.state_dict()))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-12)
    for name, t in results[0][1].items():
        np.testing.assert_allclose(results[1][1][name].numpy(), t.numpy(), atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [dict(frontend_impl="fused"), dict(attention_impl="flash")],
                         ids=["k5_op", "flash_op"])
def test_kernel_ops_in_the_model_match_the_plain_layers(rng, kw):
    """The model in train mode with the K5 op in CNN stage 0 (or the flash
    autograd Function in the attention), on their plain versions, against
    the plain stage and full attention: same loss and gradients, float64."""
    pcfg = _port_cfg(_cfg())
    x, y = (torch.from_numpy(a) for a in _batch(rng, 2))
    base = model_from_config(pcfg, generator=torch.Generator().manual_seed(2)).double()
    grads, losses, stats = [], [], []
    for cfg in (pcfg.replace(frontend_impl="xla"), pcfg.replace(**kw)):
        model = model_from_config(cfg).double()
        model.load_state_dict(base.state_dict())
        sed, doa = model(x, train=True)
        loss = seld_loss(sed, doa, y)
        loss.backward()
        losses.append(float(loss.detach()))
        # the last ResBlock's conv_res feeds nothing: no gradient in either model
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        stats.append({n: b.clone() for n, b in model.named_buffers()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-12)
    assert set(grads[1]) == set(grads[0])
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(),
                                   atol=1e-10 * max(g.abs().max().item(), 1e-30), err_msg=name)
    for name, b in stats[0].items():
        np.testing.assert_allclose(stats[1][name].numpy(), b.numpy(), atol=1e-12, err_msg=name)


def test_fused_frontend_warns_and_runs_the_plain_stage_on_the_cpu():
    """frontend_impl='fused' where stage 0 does not meet the K5 conditions (a
    biased conv): on the CPU the plain stage runs, with a warning, and gives
    the 'xla' block's output (a CUDA tensor raises: tests/test_torch_cuda.py)."""
    from seld_tpu_torch.models.blocks import ConvTCBlock

    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(3))
    outs = []
    for impl in ("fused", "xla"):
        block = ConvTCBlock("DQ", 8, 16, [16], 3, [[2, 1]], "CNN", [1], "fibonacci", 16, 16,
                            3, [16, 16], 3, use_bias=True, batch_norm="BN",
                            attention_impl="full", spatial_dropout_rate=0.0,
                            dropout_perc=0.0, frontend_impl=impl,
                            generator=torch.Generator().manual_seed(0))
        if impl == "fused":
            with pytest.warns(UserWarning, match="K5 conditions"):
                outs.append(block(x, train=True))
        else:
            outs.append(block(x, train=True))
    assert torch.equal(outs[0], outs[1])


def test_spatial_dropout_drops_whole_channels():
    x = torch.ones(4, 50, 64)
    gen = torch.Generator().manual_seed(0)
    drop = SpatialDropout1D(0.5)
    y = drop(x, train=True, generator=gen)
    assert torch.equal(y, y[:, :1].expand_as(y))            # one mask across time
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}       # kept values scale by 1/keep
    assert 0.3 < (y[:, 0] == 0).float().mean().item() < 0.7
    assert not torch.equal(drop(x, train=True, generator=gen), y)   # a fresh draw
    assert torch.equal(drop(x, train=False, generator=gen), x)
    with pytest.raises(ValueError):
        drop(x, train=True)


def test_seld_loss_matches_jax(rng):
    sed = rng.uniform(0, 1, (2, 4, 42))
    sed[0, 0, :3] = [0.0, 1.0, 1e-50]            # the -100 clamp on both logs
    doa = rng.uniform(-1, 1, (2, 4, 126))
    target = np.concatenate([(rng.uniform(size=(2, 4, 42)) < 0.3) * 1.0,
                             rng.uniform(-1, 1, (2, 4, 126))], axis=-1)
    with enable_x64(True):
        want = float(jax_seld_loss(jnp.asarray(sed), jnp.asarray(doa), jnp.asarray(target)))
    got = float(seld_loss(*(torch.from_numpy(a) for a in (sed, doa, target))))
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_step_lr_matches_jax():
    args = dict(lr0=1e-3, step_size=3, gamma=0.5, min_lr=1e-4)
    got, want = StepLRState(**args), JaxStepLR(**args)
    for _ in range(20):
        assert got.lr == want.lr and got.steps_taken == want.steps_taken
        got, want = got.epoch_step(), want.epoch_step()
    assert got.lr == 1e-3 * 0.5 ** 4 and got.epoch_step() == got   # floor reached, sticky
    off = StepLRState(**args, enabled=False)
    assert off.epoch_step() == off


def test_checkpoint_round_trip(rng, tmp_path):
    """Saving after one step and resuming in a fresh state repeats the second
    step bit for bit: model, Adam moments, step count, the dropout generator,
    the schedule and the numpy generator all come back."""
    pcfg = _port_cfg(tiny_config(dropout_perc=0.3, spatial_dropout_rate=0.5))
    x, y = (torch.from_numpy(a) for a in _batch(rng, 2, np.float32))
    step = make_train_step(pcfg)
    state = create_train_state(
        model_from_config(pcfg, generator=torch.Generator().manual_seed(3)), pcfg,
        torch.Generator().manual_seed(4))
    state, _ = step(state, x, y)
    set_learning_rate(state, 5e-4)
    sched = StepLRState(lr0=1e-3, step_size=2, gamma=0.5, min_lr=1e-5).epoch_step()
    np_rng = np.random.default_rng(5)
    path = str(tmp_path / "ckpt" / "checkpoint")
    save_checkpoint(path, state, {"epoch": 1, "best": 0.5}, sched, np_rng)
    draw = np_rng.random()
    state, loss_a = step(state, x, y)

    fresh = create_train_state(model_from_config(pcfg, generator=torch.Generator().manual_seed(9)),
                               pcfg, torch.Generator().manual_seed(10))
    np_rng2 = np.random.default_rng(0)
    fresh, loop_state, sched2 = load_checkpoint(path, fresh, np_rng2)
    assert loop_state == {"epoch": 1, "best": 0.5} and sched2 == sched and fresh.step == 1
    assert np_rng2.random() == draw
    fresh, loss_b = step(fresh, x, y)
    assert float(loss_b) == float(loss_a)
    for (name, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh.optimizer.param_groups[0]["lr"] == 5e-4


def test_eval_step_is_the_eval_forward(rng):
    pcfg = _port_cfg(_cfg())
    x, y = (torch.from_numpy(a) for a in _batch(rng, 2))
    model = model_from_config(pcfg, generator=torch.Generator().manual_seed(6)).double()
    state = create_train_state(model, pcfg, torch.Generator().manual_seed(0))
    before = {n: t.clone() for n, t in model.state_dict().items()}
    loss = make_eval_step(pcfg)(state, x, y)
    sed, doa = model(x)
    assert float(loss) == float(seld_loss(sed, doa, y).detach())
    assert all(torch.equal(before[n], t) for n, t in model.state_dict().items())


def test_bridge_round_trip(rng):
    cfg = tiny_config()
    variables = random_variables(jax_model_from_config(cfg), (1, 8, 32, 32), rng)
    model = model_from_config(_port_cfg(cfg)).double()
    from_jax_variables(variables, model)
    _assert_trees_close(to_jax_variables(model), variables, 0.0)
