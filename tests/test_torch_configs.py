"""The shipped magnitude + phase configs and the SE block in the port, against
the JAX package, on the CPU.

Topologies (``TOPOLOGIES``, tiny widths from ``tests/test_torch_model``):
2Parallel on the two halves of 8 channels (Q domain), ``parallel_magphase``
on 16 channels (DQ trunks, R classifier: the shape of
``config/DQSELD-TCN-S1-PHI_micAMagPhaseParallelmicBMagPhase.txt``), the SE
block in the R and DQ domains, and one DQ trunk on 16 channels (the shape of
``config/DQSELD-TCN-S1-PHI_16chMagPhase.txt``).

- ``SEBlock`` against the JAX ``SEBlock``, float64, 1e-12;
- the whole model in float64 (ladder rung 1), weights through
  ``from_jax_variables``, in eval mode and in train mode with dropout 0
  (outputs and the updated BN statistics), against JAX ``model.apply``,
  1e-12 as ``tests/test_torch_model.py``;
- ``fused_infer`` (the kernels' plain versions on the CPU) in float32
  against JAX ``model.apply`` in float32, 2e-4 x max;
- one training step's gradients of the ``parallel_magphase`` model against
  ``jax.value_and_grad`` of the JAX train step's loss, float64, 1e-9 x max
  per parameter; and the same model with ``frontend_impl='ct'`` (K5 and K9's
  plain versions in each trunk) against its plain stages: loss, gradients
  and each trunk's BN running statistics;
- the kernel routes refuse what JAX's refuse: the SE block, and K5 at Cin
  16; on a CUDA tensor 'ct' / 'fused' raise;
- ``serve(..., phase=True)`` (float32 and bfloat16) against JAX
  ``model.apply`` on the same features, and the predict CLI on a tiny phase +
  2Parallel config (``--impl fused`` and ``apply`` write the CSVs and agree);
- the port's Trainer for one epoch of a tiny magnitude + phase 2Parallel
  config on a 16-channel synthetic dataset;
- every entry point raises without a card unless the CPU is asked for;
- ``from_jax_variables`` / ``to_jax_variables`` round trips through
  ``branch_A``, ``branch_B`` and ``se_{i}``.
"""

import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax._src.config import enable_x64

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.models.layers import SEBlock as JaxSEBlock
from seld_tpu.training.loss import seld_loss as jax_seld_loss
from seld_tpu_torch import predict
from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data import features
from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset, make_task2_batch
from seld_tpu_torch.metrics import gen_submission_list_task2
from seld_tpu_torch.models.fused_infer import fused_infer
from seld_tpu_torch.models.layers import SEBlock
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.serve import serve
from seld_tpu_torch.training import seld_loss
from seld_tpu_torch.training.checkpoint import ROLES
from seld_tpu_torch.training.trainer import Trainer
from seld_tpu_torch.utils.jax_bridge import from_jax_variables, to_jax_variables
from tests.test_torch_model import F64_TOL, random_variables, tiny_config

FUSED_TOL = 2e-4     # x max|ref|: float32, the same sums in another order
GRAD_TOL = 1e-9      # x max|grad| per parameter, float64
BF16_TOL = 0.05      # bf16 serving against float32, on sigmoid / tanh outputs
MAGPHASE = dict(domain="DQ", domain_classifier="R", input_channels=16, phase=True, n_mics=2,
                parallel_ConvTC_block="2Parallel", parallel_magphase=True)
TOPOLOGIES = {
    "2parallel": dict(domain="Q", input_channels=8, parallel_ConvTC_block="2Parallel"),
    "magphase": MAGPHASE,
    "se_r": dict(domain="R", use_se_block=True),
    "se_dq": dict(domain="DQ", use_se_block=True),
}
TRUNKS = {"2parallel": ("branch_A", "branch_B"), "magphase": ("branch_A", "branch_B")}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _x(rng, cfg, b=2, dtype=np.float64):
    return rng.standard_normal((b, cfg.input_channels, 32, 32)).astype(dtype)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def _bridged(cfg, variables, dtype=torch.float64):
    model = model_from_config(cfg).to(dtype)
    from_jax_variables(variables, model)
    return model


@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (3, 7, 24), (2, 4, 3, 3)])
def test_se_block_matches_jax(rng, shape):
    x = rng.standard_normal(shape)
    c = shape[-1]
    variables = {"params": {
        "Dense_0": {"kernel": rng.standard_normal((c, max(c // 8, 1))), "bias":
                    0.1 * rng.standard_normal(max(c // 8, 1))},
        "Dense_1": {"kernel": rng.standard_normal((max(c // 8, 1), c)),
                    "bias": 0.1 * rng.standard_normal(c)}}}
    with enable_x64(True):
        want = JaxSEBlock().apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    se = SEBlock(c).double()
    from_jax_variables(variables, se)
    got = se(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_model_matches_jax_apply(rng, topology, train):
    cfg = tiny_config(**TOPOLOGIES[topology], dropout_perc=0.0, spatial_dropout_rate=0.0)
    x = _x(rng, cfg)
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, *x.shape[1:]), rng)
    with enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, variables)
        if train:
            (sed_ref, doa_ref), upd = jax.jit(lambda v, a: jmodel.apply(
                v, a, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"]))(v, jnp.asarray(x))
        else:
            sed_ref, doa_ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
                v, jnp.asarray(x))
    model = _bridged(cfg, variables)
    assert model.trunk_names == TRUNKS.get(topology, ("seld_block",))
    with torch.no_grad():
        sed, doa = model(torch.from_numpy(x), train=train, generator=torch.Generator())
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    np.testing.assert_allclose(sed.numpy(), np.asarray(sed_ref), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(doa.numpy(), np.asarray(doa_ref), rtol=0, atol=F64_TOL)
    if train:   # each trunk's BN statistics updated from its own channels
        got = dict(_flat(to_jax_variables(model)["batch_stats"]))
        want = dict(_flat(jax.device_get(upd["batch_stats"])))
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=F64_TOL, err_msg=name)


@pytest.mark.parametrize("topology", [*TOPOLOGIES, "16ch"])
def test_fused_infer_matches_jax_apply(rng, topology):
    kw = dict(domain="DQ", input_channels=16) if topology == "16ch" else TOPOLOGIES[topology]
    cfg = tiny_config(**kw)
    x = _x(rng, cfg, dtype=np.float32)
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, *x.shape[1:]), rng, dtype=np.float32)
    sed_ref, doa_ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    model = _bridged(cfg, variables, torch.float32)
    sed, doa = fused_infer(model, torch.from_numpy(x))
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FUSED_TOL * np.abs(want).max())


def _grads_by_path(model) -> dict:
    return {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def test_magphase_train_step_gradients_match_jax(rng):
    cfg = tiny_config(**MAGPHASE, dropout_perc=0.0, spatial_dropout_rate=0.0)
    x, y = (a.astype(np.float64) for a in make_task2_batch(
        rng, 2, channels=16, freq=32, time_frames=32, label_frames=4))
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, *x.shape[1:]), rng)
    with enable_x64(True):
        v = jax.tree_util.tree_map(jnp.asarray, variables)

        def loss_fn(params):
            (sed, doa), _ = jmodel.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return jax_seld_loss(sed, doa, jnp.asarray(y))

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        jgrads = dict(_flat(jax.device_get(jgrads)))
    model = _bridged(cfg, variables)
    sed, doa = model(torch.from_numpy(x), train=True, generator=torch.Generator())
    loss = seld_loss(sed, doa, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-12)
    grads = _grads_by_path(model)
    # each trunk's last ResBlock's conv_res feeds nothing: no port gradient, JAX zeros
    assert {n for n in jgrads if n not in grads} == {
        f"{t}/tcn/resblock_1/conv_res/{leaf}" for t in TRUNKS["magphase"] for leaf in ("w", "b")
        if f"{t}/tcn/resblock_1/conv_res/{leaf}" in jgrads}
    assert any(n.startswith("branch_A/") for n in grads) and any(
        n.startswith("branch_B/") for n in grads)
    for name, want in jgrads.items():
        got = grads.get(name, np.zeros_like(want))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(want).max(), 1e-30), err_msg=name)


def test_magphase_ct_route_matches_the_plain_stages(rng):
    """frontend_impl='ct' in both trunks (K5 at stage 0, K9 after it, their
    plain versions on the CPU) against the plain stages, float64, dropout 0:
    the same loss and gradients, and each trunk's BN running statistics
    counted over that trunk's B * F * T."""
    cfg = tiny_config(**MAGPHASE, dropout_perc=0.0, spatial_dropout_rate=0.0)
    x, y = (torch.from_numpy(a.astype(np.float64)) for a in make_task2_batch(
        rng, 2, channels=16, freq=32, time_frames=32, label_frames=4))
    base = model_from_config(cfg, generator=torch.Generator().manual_seed(3)).double()
    for bn in (m for n, m in base.named_modules() if n.split(".")[-1].startswith("cnn_bn")):
        bn.mean.normal_(0.0, 0.1)
        bn.var.uniform_(0.5, 1.5)
    runs = []
    for impl in ("xla", "ct"):
        model = model_from_config(cfg.replace(frontend_impl=impl)).double()
        model.load_state_dict(base.state_dict())
        assert all(t.frontend_impl == impl for t in model.trunks)
        sed, doa = model(x, train=True, generator=torch.Generator())
        loss = seld_loss(sed, doa, y)
        loss.backward()
        runs.append((loss.item(), _grads_by_path(model),
                     {n: b.clone() for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-12)
    assert set(g1) == set(g0)
    for name, want in g0.items():
        np.testing.assert_allclose(g1[name], want, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(want).max(), 1e-30), err_msg=name)
    for name, want in b0.items():
        np.testing.assert_allclose(b1[name].numpy(), want.numpy(), rtol=0, atol=1e-12,
                                   err_msg=name)


def _fake_cuda(shape, dtype=torch.bfloat16):
    """Stands in for a CUDA tensor where the routing reads only its shape,
    dtype and device."""
    return types.SimpleNamespace(shape=shape, is_cuda=True, dtype=dtype)


def test_kernel_routes_refuse_se_and_k5_at_cin_16():
    """As ``seld_tpu/models/blocks.py``: neither K5 nor the K5 + K9 chain
    takes a trunk with the SE block, and K5 no stage 0 at 3 * Cin > 32 (the
    16chMagPhase config): 'auto' takes the plain stages, 'ct' and 'fused'
    raise on a CUDA tensor and warn on the CPU."""
    se = model_from_config(tiny_config(domain="DQ", use_se_block=True)).seld_block
    wide = model_from_config(tiny_config(domain="DQ", input_channels=16)).seld_block
    for trunk, cin in ((se, 8), (wide, 16)):
        x = _fake_cuda((2, 32, 32, cin))
        trunk.frontend_impl = "auto"
        assert not trunk._fused_train_ok(x, trunk.pools[0]) and not trunk._ct_train_ok(x)
        for impl, ok in (("ct", trunk._ct_train_ok),
                         ("fused", lambda a: trunk._fused_train_ok(a, trunk.pools[0]))):
            trunk.frontend_impl = impl
            with pytest.raises(ValueError, match="SE block" if trunk is se else "3 \\* Cin"):
                ok(x)
            with pytest.warns(UserWarning, match="the plain stage"):
                assert not ok(torch.zeros(2, 32, 32, cin))
    plain = model_from_config(tiny_config(domain="DQ", frontend_impl="ct")).seld_block
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert plain._ct_train_ok(_fake_cuda((2, 32, 32, 8)))


def _serving_config(compute_dtype="float32"):
    """The flagship's frequency path (F 256, pools 8 / 8 / 2) at tiny widths,
    magnitude + phase 2Parallel."""
    return tiny_config(**MAGPHASE, freq_dim=256, cnn_filters=[8, 16, 16],
                       pool_size=[[8, 2], [8, 2], [2, 2]], D=[3], G=16, U=16,
                       compute_dtype=compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_serve_with_phase_matches_jax_apply(rng, compute_dtype):
    cfg = _serving_config(compute_dtype)
    jmodel = jax_model_from_config(cfg.replace(compute_dtype="float32"))
    variables = random_variables(jmodel, (1, 16, 256, 32), rng, dtype=np.float32)
    audio = torch.from_numpy(rng.standard_normal((2, 8, 12800)).astype(np.float32))
    feats = features.spectrum_fast_batch(audio, nperseg=512, noverlap=112)
    assert feats.shape == (2, 16, 256, 32)
    sed_ref, doa_ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(feats.numpy()))
    model = _bridged(cfg, variables, torch.float32)
    sed, doa = serve(model, audio, phase=True)
    assert sed.shape == (2, 4, 42) and doa.shape == (2, 4, 126)
    for got, want in ((sed, sed_ref), (doa, doa_ref)):
        want = np.asarray(want)
        tol = FUSED_TOL * np.abs(want).max() if compute_dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="8 feature channels; the model takes 16"):
        serve(model, audio)


CLI_CFG = """--domain=DQ
--domain_classifier=R
--parallel_ConvTC_block=2Parallel
--parallel_magphase=True
--phase=True
--n_mics=2
--input_channels=16
--cnn_filters=[8,8,8]
--G=8
--U=8
--V=[16,16]
--fc_layers=[16]
--freq_dim=256
--pool_size=[[8,2],[8,2],[2,2]]
--pool_time=TCN
--D=[2]
--use_bias_conv=False
--batch_norm=BN
"""


def test_predict_cli_on_a_phase_2parallel_config(tmp_path, rng):
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    clip = tmp_path / "clip.npy"
    np.save(clip, rng.standard_normal((8, 32000)).astype(np.float32))
    runs = {}
    for impl in ("fused", "apply"):
        out_dir = tmp_path / impl
        (r,) = predict.main([f"--TextArgs={cfg_file}", "--inputs", str(clip),
                             f"--out-dir={out_dir}", f"--impl={impl}", "--device=cpu"])
        assert r["csv"] == str(out_dir / "clip.csv")
        assert r["sed"].shape == (10, 42) and r["doa"].shape == (10, 126)
        events, _ = gen_submission_list_task2(r["sed"], r["doa"], max_loc_value=2.0,
                                              num_classes=14, max_overlaps=3)
        want = tmp_path / f"{impl}_want.csv"
        pd.DataFrame(events).to_csv(want, index=None, header=None)
        assert open(r["csv"], "rb").read() == want.read_bytes()
        runs[impl] = r
    for key in ("sed", "doa"):
        want = runs["apply"][key]
        np.testing.assert_allclose(runs["fused"][key], want, rtol=0,
                                   atol=FUSED_TOL * np.abs(want).max())


def test_trainer_one_epoch_of_a_magphase_2parallel_config(tmp_path, monkeypatch):
    """The port's Trainer on a 16-channel synthetic set (8 magnitude + 8
    phase channels, each group z-scored on its own by
    ``data/normalize.py``): one epoch of a tiny magnitude + phase 2Parallel
    config, finite losses, the latest and best checkpoints and a test row (the
    best-on-test role waits for a Global SELD under 1). (Its
    model's training step is held to JAX's by
    ``test_magphase_train_step_gradients_match_jax``; the single-trunk
    Trainer to JAX's Trainer by ``tests/test_torch_trainer.py``.)"""
    monkeypatch.chdir(tmp_path)
    paths = gen_fake_task2_dataset(str(tmp_path / "data"), n_train=4, n_val=2, n_test=2,
                                   channels=16, freq=16, time_frames=16, label_frames=2)
    cfg = SELDConfig(
        **MAGPHASE, freq_dim=16, time_dim=16, cnn_filters=[8, 8, 8],
        pool_size=[[2, 2], [2, 2], [2, 2]], D=[2], G=8, U=8, V=[8, 8], fc_layers=[8],
        batch_size=2, lr=1e-3, num_frames=2, test_step=1, checkpoint_step=2, min_n_epochs=1,
        patience=1000, attention_impl="full", pool_time="TCN", dataset_normalization="True",
        results_path="results",
        training_predictors_path=paths["train"][0], training_target_path=paths["train"][1],
        validation_predictors_path=paths["validation"][0],
        validation_target_path=paths["validation"][1],
        test_predictors_path=paths["test"][0], test_target_path=paths["test"][1])
    trainer = Trainer(cfg, verbose=False, device="cpu")
    trainer.setup_data()
    train_x = np.concatenate([x for x, _ in trainer.loaders["train"]])
    assert train_x.shape[1:] == (16, 16, 16)
    for group in (slice(0, 8), slice(8, 16)):   # z-scored per group
        np.testing.assert_allclose(train_x[:, group].mean(), 0.0, atol=1e-5)
        np.testing.assert_allclose(train_x[:, group].std(), 1.0, atol=1e-4)
    trainer.setup_model()
    assert trainer.model.trunk_names == ("branch_A", "branch_B")
    assert "_2Parallel_" in trainer.model.model_name
    results = trainer.fit(max_epochs=1)
    assert len(results["train_loss_hist"]) == 1
    assert all(np.isfinite(results[k]) for k in ("train_loss", "val_loss", "test_loss"))
    assert len(results["final_test"]) == 16
    model_dir = os.path.join("RESULTS_Original", "Task2", cfg.architecture,
                             trainer.model.model_name + cfg.model_extra_name)
    for role in ("checkpoint", "checkpoint_best"):
        assert os.path.isfile(os.path.join(model_dir, ROLES[role])), role


def test_entry_points_run_on_the_card_by_default(tmp_path, monkeypatch):
    """With no card and no ``--device``, every entry point of the port raises
    and names the CPU switch: none moves to the CPU by itself (the phase +
    2Parallel config here; the predict and train CLIs' own tests do it for
    the flagship's)."""
    from seld_tpu_torch import ab_variants, export_serving, profile_stages, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        predict.main([f"--TextArgs={cfg_file}", "--inputs", "x.npy"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main([f"--TextArgs={cfg_file}"])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        profile_stages.main([])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        ab_variants.main(["--digest"])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        export_serving.main([f"--TextArgs={cfg_file}"])


@pytest.mark.parametrize("topology", ["2parallel", "magphase", "se_dq"])
def test_bridge_round_trips_trunks_and_se(rng, topology):
    cfg = tiny_config(**TOPOLOGIES[topology])
    jmodel = jax_model_from_config(cfg)
    variables = random_variables(jmodel, (1, cfg.input_channels, 32, 32), rng)
    model = _bridged(cfg, variables)
    tree = to_jax_variables(model)
    for collection in ("params", "batch_stats"):
        got, want = dict(_flat(tree[collection])), dict(_flat(variables[collection]))
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    names = set(dict(_flat(tree["params"])))
    for trunk in TRUNKS.get(topology, ("seld_block",)):
        assert any(n.startswith(f"{trunk}/cnn_0/") for n in names)
    if topology == "se_dq":
        assert {"seld_block/se_0/Dense_0/kernel", "seld_block/se_1/Dense_1/bias"} <= names
