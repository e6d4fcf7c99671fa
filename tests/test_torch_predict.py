"""The port's ``qconv_impl`` route and its predict CLI against the JAX
package, on the CPU.

- the model: tiny Q and DQ ``SELDModel``s (``tests/test_pallas.py``'s widths)
  on bridged weights, float32: the port's ``'pallas'`` model (K7's plain
  version) against the JAX ``'pallas'`` model in interpret mode at 1e-5 (the
  JAX package's own bound against XLA), the port's ``'int8'`` model (K8's)
  against the JAX ``'int8'`` model at 1e-3 (it allows a rare rounding flip
  of one activation's int8 value, from float32 sums taken in another order
  upstream), and the ``'int8'`` model differing from the port's ``'xla'`` one
  by more than that (``model_from_config`` used to drop ``qconv_impl``);
- one float32 train step with ``qconv_impl='pallas'`` (the K7 Function's
  forward and backward) against the JAX model's train-mode loss and
  ``jax.grad`` in interpret mode (the loss ``seld_tpu.training.steps.
  make_train_step`` takes), dropout off: loss within 1e-6 relative, each
  gradient within 1e-5 relative norm;
- the CLI ``python -m seld_tpu_torch.predict --device=cpu`` on a tiny
  ``freq_dim=256`` config with a port checkpoint: CSVs byte-equal to
  ``pd.DataFrame(events).to_csv``, a mismatched checkpoint exits with the
  shape list, and the default device raises without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile as wavfile
import torch
from jax.experimental.pallas import tpu as pltpu

from seld_tpu.config import SELDConfig as JaxConfig
from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.training.loss import seld_loss as jax_seld_loss
from seld_tpu_torch import predict
from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data.synthetic import make_task2_batch
from seld_tpu_torch.metrics import gen_submission_list_task2
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.training import create_train_state, make_train_step, save_checkpoint
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.test_torch_model import random_variables

INT8_TOL = 1e-3


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _cfg(**kw) -> JaxConfig:
    """tests/test_pallas.py's tiny model (F = T = 16, CNN 8 / 8 / 8, one stack
    of 2 ResBlocks, G = U = 8, V = (16, 16), FC 16)."""
    base = dict(time_dim=16, freq_dim=16, input_channels=8, output_classes=14, domain="DQ",
                domain_classifier="same", cnn_filters=[8, 8, 8],
                pool_size=[[2, 2], [2, 2], [2, 2]], pool_time="TCN", D=[2], G=8, U=8,
                V=[16, 16], fc_layers=[16], use_bias_conv=False, use_bias_linear=True,
                batch_norm="BN", attention_impl="full")
    base.update(kw)
    return JaxConfig(**base)


def _port_cfg(cfg) -> SELDConfig:
    return SELDConfig(**{k: getattr(cfg, k) for k in SELDConfig.field_names()})


def _port_model(cfg, variables):
    model = model_from_config(_port_cfg(cfg))
    from_jax_variables(variables, model)
    return model.eval()


def _port_apply(model, x):
    with torch.no_grad():
        return [a.numpy() for a in model(torch.from_numpy(x))]


@pytest.mark.parametrize("domain,bias", [("Q", False), ("DQ", False), ("DQ", True)])
def test_qconv_impl_reaches_the_layers(rng, domain, bias):
    """K7's and K8's plain versions inside the eval model against the JAX
    'pallas' and 'int8' models; 'int8' is not the 'xla' model."""
    x = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    cfg = _cfg(domain=domain, use_bias_conv=bias)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng, np.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    outs = {}
    for impl in ("xla", "pallas", "int8"):
        c = cfg.replace(qconv_impl=impl)
        model = _port_model(c, variables)
        assert model.qconv_impl == impl
        assert model.sed_fc0.impl == impl and model.seld_block.tcn.resblock_0.conv_skip.impl == impl
        outs[impl] = _port_apply(model, x)
        if impl == "xla":   # held to the JAX model in float64 by tests/test_torch_model.py
            continue
        jmodel = jax_model_from_config(c)
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
        tol = 1e-5 if impl == "pallas" else INT8_TOL
        for got, w in zip(outs[impl], want):
            d = np.abs(got - np.asarray(w)).max()
            print(f"{domain} bias={bias} {impl}: max|port - jax| {d:.3e}")
            assert d <= tol, (impl, d)
    gap = max(np.abs(a - b).max() for a, b in zip(outs["int8"], outs["xla"]))
    print(f"{domain} bias={bias}: max|int8 - xla| {gap:.3e}")
    assert gap > INT8_TOL


def test_unknown_qconv_impl_maps_to_xla():
    assert model_from_config(_port_cfg(_cfg(qconv_impl="auto"))).qconv_impl == "xla"


def test_pallas_train_step_matches_jax(rng):
    """One float32 step of the 'pallas' model (the K7 Function's forward and
    dx, structured dW) against the JAX step in interpret mode."""
    cfg = _cfg(qconv_impl="pallas", dropout_perc=0.0, spatial_dropout_rate=0.0, lr=1e-3,
               use_remat=False)   # remat cannot take interpret mode's callbacks
    x, y = make_task2_batch(rng, 2, channels=8, freq=16, time_frames=16, label_frames=2)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng, np.float32)
    jmodel = jax_model_from_config(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    def loss_fn(p):
        (sed, doa), _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                     train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_seld_loss(sed, doa, jnp.asarray(y))

    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    model = model_from_config(_port_cfg(cfg))
    from_jax_variables(variables, model)
    state = create_train_state(model, _port_cfg(cfg), torch.Generator().manual_seed(0))
    _, loss = make_train_step(_port_cfg(cfg))(state, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]:
        want[".".join(str(p.key) for p in path)] = np.asarray(leaf)
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) <= set(want) and len(got) >= len(want) - 1   # the last conv_res feeds nothing
    for name, g in got.items():
        rel = np.linalg.norm(g - want[name]) / max(np.linalg.norm(want[name]), 1e-30)
        assert rel <= 1e-5, (name, rel)


# ---- the CLI ----------------------------------------------------------------

CLI_CFG = """--domain=DQ
--domain_classifier=DQ
--input_channels=8
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
--attention_impl=full
"""


def _inputs(tmp_path, rng):
    npy, wav = tmp_path / "clip_a.npy", tmp_path / "clip_b.wav"
    np.save(npy, rng.standard_normal((8, 32000)).astype(np.float32))
    wavfile.write(wav, 32000, (rng.standard_normal((32000, 8)) * 3000).astype(np.int16))
    return [str(npy), str(wav)]


def _checkpoint(path, cfg_text, tmp_path, seed):
    from seld_tpu_torch.config import load_config

    f = tmp_path / f"cfg_{seed}.txt"
    f.write_text(cfg_text)
    cfg = load_config(str(f))
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(seed))
    save_checkpoint(str(path), create_train_state(model, cfg, torch.Generator()), {})


@pytest.mark.parametrize("impl", ["apply", "fused"])
def test_predict_cli_writes_the_jax_clis_csvs(tmp_path, rng, impl):
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    ckpt = tmp_path / "checkpoint_best_model"
    _checkpoint(ckpt, CLI_CFG, tmp_path, seed=3)
    inputs = _inputs(tmp_path, rng)
    out_dir = tmp_path / "subs"
    results = predict.main([f"--TextArgs={cfg_file}", f"--checkpoint={ckpt}", "--inputs",
                            *inputs, f"--out-dir={out_dir}", f"--impl={impl}", "--device=cpu"])
    assert [r["csv"] for r in results] == [str(out_dir / "clip_a.csv"),
                                           str(out_dir / "clip_b.csv")]
    for r in results:
        assert r["sed"].shape == (10, 42) and r["doa"].shape == (10, 126)
        events, _ = gen_submission_list_task2(r["sed"], r["doa"], max_loc_value=2.0,
                                              num_classes=14, max_overlaps=3)
        assert r["events"] == len(events) > 0
        want = tmp_path / "want.csv"
        pd.DataFrame(events).to_csv(want, index=None, header=None)
        assert open(r["csv"], "rb").read() == want.read_bytes()
    # an empty event list writes an empty file, as pandas does
    from seld_tpu_torch.utils.io import write_submission_csv

    write_submission_csv(str(tmp_path / "none.csv"), np.empty((0,)))
    pd.DataFrame(np.empty((0,))).to_csv(tmp_path / "none_pd.csv", index=None, header=None)
    assert (tmp_path / "none.csv").read_bytes() == (tmp_path / "none_pd.csv").read_bytes() == b""


def test_predict_cli_refuses_a_mismatched_checkpoint(tmp_path, rng):
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    ckpt = tmp_path / "ckpt"
    _checkpoint(ckpt, CLI_CFG.replace("--G=8", "--G=16"), tmp_path, seed=1)
    with pytest.raises(SystemExit, match="shape mismatch: seld_block.tcn.resblock_0"):
        predict.main([f"--TextArgs={cfg_file}", f"--checkpoint={ckpt}", "--inputs",
                      *_inputs(tmp_path, rng), f"--out-dir={tmp_path}", "--device=cpu"])


def test_predict_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        predict.main([f"--TextArgs={cfg_file}", "--inputs", *_inputs(tmp_path, rng)])
    # a magnitude + phase config runs: 8-channel audio, 16 feature channels
    (r,) = predict.main([f"--TextArgs={cfg_file}", "--inputs", _inputs(tmp_path, rng)[0],
                         "--device=cpu", f"--out-dir={tmp_path / 'phase'}", "--phase=True",
                         "--input_channels=16"])
    assert r["sed"].shape == (10, 42) and r["doa"].shape == (10, 126)
    assert np.isfinite(r["sed"]).all() and os.path.isfile(r["csv"])
