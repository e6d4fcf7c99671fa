"""The port's training entry point against the JAX package, on the CPU.

- the port's copies of the metrics, the decode, the loader's batch order,
  the normalization and the synthetic dataset writer against ``seld_tpu``'s
  on the same numpy inputs: copies, so equal;
- ``Trainer(cfg, device="cpu")`` against ``seld_tpu.training.Trainer`` on
  ``tests/test_trainer.py::_cfg``'s tiny synthetic set, with dropout off and
  the port's initial weights bridged from the JAX trainer's: two epochs,
  train and val loss histories within 1e-4 relative, the four checkpoint
  roles, the CSVs, ``results_dict.json`` and ``checkpoint_epoch_2/``; then a
  fresh trainer resumes and runs a third epoch;
- the CLI ``python -m seld_tpu_torch.train --device=cpu --max_epochs=1``;
- ``Trainer()`` without a card and without ``device`` raises.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from seld_tpu.data import loader as jax_loader
from seld_tpu.data import normalize as jax_normalize
from seld_tpu.data.synthetic import gen_fake_task2_dataset as jax_gen_dataset
from seld_tpu.metrics import SELDMetrics as JaxSELDMetrics
from seld_tpu.metrics import gen_submission_list_task2 as jax_decode
from seld_tpu.metrics import location_sensitive_detection as jax_lsd
from seld_tpu.metrics import segment_labels as jax_segment_labels
from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.training import Trainer as JaxTrainer
from seld_tpu.utils import model_summary as jax_model_summary
from seld_tpu_torch import train as port_cli
from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data import loader, normalize
from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset
from seld_tpu_torch.metrics import (
    SELDMetrics, gen_submission_list_task2, location_sensitive_detection, segment_labels,
)
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.training.checkpoint import ROLES
from seld_tpu_torch.training.trainer import Trainer
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from seld_tpu_torch.utils.summary import model_summary
from tests.test_trainer import _cfg as jax_trainer_cfg


def _outputs(rng, frames=30, classes=14, overlaps=3):
    sed = rng.uniform(0, 1, (frames, classes * overlaps))
    doa = rng.uniform(-1, 1, (frames, classes * overlaps * 3))
    return sed, doa


def test_metrics_and_decode_equal_the_jax_package(rng):
    for _ in range(3):
        (sed, doa), (sed_t, doa_t) = _outputs(rng), _outputs(rng)
        sed_t = (sed_t > 0.8) * 1.0
        got, got_dict = gen_submission_list_task2(sed, doa, num_frames=30)
        want, want_dict = jax_decode(sed, doa, num_frames=30)
        np.testing.assert_array_equal(got, want)
        assert got_dict == want_dict
        truth, truth_dict = gen_submission_list_task2(sed_t, doa_t, num_frames=30)
        assert (location_sensitive_detection(got, truth, 30, 2.0)
                == jax_lsd(got, truth, 30, 2.0))
        assert segment_labels(got_dict, 30) == jax_segment_labels(got_dict, 30)
        port_m, jax_m = SELDMetrics(), JaxSELDMetrics()
        for m, seg in ((port_m, segment_labels), (jax_m, jax_segment_labels)):
            m.update_seld_scores(seg(got_dict, 30), seg(truth_dict, 30))
        assert port_m.compute_seld_scores() == jax_m.compute_seld_scores()


@pytest.mark.parametrize("kw", [dict(mode="True", n_mics=1), dict(mode="True", n_mics=2),
                                dict(mode="True", n_mics=1, phase=True),
                                dict(mode="UnitNorm", n_mics=2, domain="DQ"),
                                dict(mode="False")],
                         ids=["zscore_1mic", "zscore_2mic", "zscore_phase", "unitnorm", "off"])
def test_normalization_equals_the_jax_package(rng, kw):
    predictors = {s: rng.standard_normal((3, 8, 4, 5)).astype(np.float32)
                  for s in ("train", "val", "test")}
    got = normalize.normalize_dataset(predictors, **kw)
    want = jax_normalize.normalize_dataset(predictors, **kw)
    for split in predictors:
        np.testing.assert_array_equal(got[split], want[split])


def test_loader_visits_batches_in_the_jax_order(rng):
    x = rng.standard_normal((11, 2, 3)).astype(np.float32)
    y = np.arange(11, dtype=np.float32)[:, None]
    data = {s: x for s in ("train", "val", "test")}, {s: y for s in ("train", "val", "test")}
    got = loader.make_loaders(*data, batch_size=4, seed=1)
    want = jax_loader.make_loaders(*data, batch_size=4, seed=1)
    for split in ("train", "val", "test"):
        for epoch in (1, 2, 3):
            got[split].set_epoch(epoch)
            want[split].set_epoch(epoch)
            assert len(got[split]) == len(want[split])
            for (gx, gy), (wx, wy) in zip(got[split], want[split], strict=True):
                np.testing.assert_array_equal(gy, wy)
                np.testing.assert_array_equal(gx, wx)


def test_synthetic_dataset_and_pickle_loading_equal_the_jax_package(tmp_path):
    kw = dict(n_train=3, n_val=2, n_test=1, channels=4, freq=8, time_frames=6, label_frames=2,
              seed=5)
    got = gen_fake_task2_dataset(str(tmp_path / "port"), **kw)
    want = jax_gen_dataset(str(tmp_path / "jax"), **kw)
    for split in ("train", "validation", "test"):
        for g, w in zip(got[split], want[split]):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                np.testing.assert_array_equal(pickle.load(fg), pickle.load(fw))
    cfg = SELDConfig(training_predictors_path=got["train"][0],
                     training_target_path=got["train"][1],
                     validation_predictors_path=got["validation"][0],
                     validation_target_path=got["validation"][1],
                     test_predictors_path=got["test"][0], test_target_path=got["test"][1])
    predictors, targets = loader.load_task2_pickles(cfg)
    assert [len(predictors[s]) for s in ("train", "val", "test")] == [3, 2, 1]
    with pytest.raises(FileNotFoundError, match="seldpak"):
        loader.load_task2_pickles(cfg.replace(training_predictors_path="data.seldpak"))
    with pytest.raises(FileNotFoundError, match="validation_target_path"):
        loader.load_task2_pickles(cfg.replace(validation_target_path=str(tmp_path / "none")))


def _port_cfg(cfg) -> SELDConfig:
    return SELDConfig(**{k: getattr(cfg, k) for k in SELDConfig.field_names()})


def test_model_name_and_summary_equal_the_jax_package():
    for kw in (dict(), dict(domain="DQ", pool_time="CNN", D=[2, 3]), dict(batch_norm="noBN")):
        base = SELDConfig(**{**dict(domain="Q", input_channels=8, freq_dim=16,
                                    cnn_filters=[8, 8], pool_size=[[2, 2], [2, 2], [2, 2]],
                                    D=[2], G=8, U=8, V=[8, 8], fc_layers=[8], pool_time="TCN"),
                             **kw})
        jmodel, model = jax_model_from_config(base), model_from_config(base)
        assert model.model_name == jmodel.model_name
        variables = jax.eval_shape(lambda k: jmodel.init(
            k, jax.numpy.zeros((1, 8, 16, 16)), train=False), jax.random.PRNGKey(0))
        want = jax_model_summary(variables["params"], depth=2).splitlines()
        got = model_summary(model, depth=2).splitlines()
        assert sorted(got) == sorted(want)


def _train_both(tmp_path, monkeypatch, epochs):
    """The JAX and the port trainer from the same initial weights on the same
    tiny synthetic set (each in a directory of its own); returns (jax
    results, port results, the port's config, the port trainer)."""
    cfg = jax_trainer_cfg(tmp_path, dropout_perc=0.0, spatial_dropout_rate=0.0, mesh_data=1,
                          results_path="results", test_step=1, checkpoint_step=2)
    runs = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            trainer = JaxTrainer(cfg, verbose=False)
        else:
            trainer = Trainer(_port_cfg(cfg), verbose=False, device="cpu")
        trainer.setup_data()
        trainer.setup_model()
        if side == "jax":
            variables = {"params": jax.device_get(trainer.state.params),
                         "batch_stats": jax.device_get(trainer.state.batch_stats)}
        else:
            from_jax_variables(variables, trainer.model)
        runs[side] = (trainer.fit(max_epochs=epochs), trainer)
    return runs["jax"][0], runs["port"][0], _port_cfg(cfg), runs["port"][1]


def test_trainer_matches_the_jax_trainer_and_resumes(tmp_path, monkeypatch):
    want, got, cfg, trainer = _train_both(tmp_path, monkeypatch, epochs=2)
    for key in ("train_loss_hist", "val_loss_hist"):
        assert len(got[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert len(got["final_test"]) == 16

    name = trainer.model.model_name + cfg.model_extra_name
    model_dir = os.path.join("RESULTS_Original", "Task2", cfg.architecture, name)
    for f in ROLES.values():
        assert os.path.isfile(os.path.join(model_dir, f)), f
    assert os.path.isdir(os.path.join(model_dir, "checkpoint_epoch_2"))
    csvs = [f for f in os.listdir(model_dir) if f.endswith(".csv")]
    assert any("training_metrics" in f for f in csvs) and any("test_metrics" in f for f in csvs)
    with open(os.path.join(cfg.results_path, "results_dict.json")) as f:
        assert json.load(f)["train_loss_hist"] == got["train_loss_hist"]

    resumed = Trainer(cfg, verbose=False, device="cpu")
    resumed.setup_data()
    resumed.setup_model()
    results = resumed.fit(max_epochs=3)   # epochs 2 -> 3
    assert len(results["train_loss_hist"]) == 1 and np.isfinite(results["train_loss"])
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [1, 2, 3]


def test_train_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = jax_trainer_cfg(tmp_path)
    lines = [f"--{k}={getattr(cfg, k)}" for k in (
        "domain input_channels freq_dim time_dim n_mics batch_size lr num_frames test_step "
        "checkpoint_step min_n_epochs patience attention_impl pool_time "
        "training_predictors_path training_target_path validation_predictors_path "
        "validation_target_path test_predictors_path test_target_path results_path").split()]
    lines += ["--cnn_filters=[8,8,8]", "--pool_size=[[2,2],[2,2],[2,2]]", "--D=[2]", "--G=8",
              "--U=8", "--V=[8,8]", "--fc_layers=[8]"]
    cfg_file = tmp_path / "test_config.txt"
    cfg_file.write_text("\n".join(lines) + "\n")
    results = port_cli.main([f"--TextArgs={cfg_file}", "--max_epochs=1", "--device=cpu",
                             "--use_bias_conv=False"])
    assert np.isfinite(results["test_loss"]) and len(results["train_loss_hist"]) == 1
    out = capsys.readouterr().out
    assert "RESULTS" in out and "test_loss" in out


def test_trainer_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(SELDConfig())
    with pytest.raises(ValueError, match="world size"):   # one process: a data axis of 1
        Trainer(SELDConfig(mesh_data=2), device="cpu")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        Trainer(SELDConfig(mesh_model=2), device="cpu")
    # the 2Parallel trunks build (their training: tests/test_torch_configs.py)
    trainer = Trainer(SELDConfig(parallel_ConvTC_block="2Parallel", input_channels=16),
                      device="cpu", verbose=False)
    trainer.setup_model()
    assert trainer.model.trunk_names == ("branch_A", "branch_B")
    assert [t.cnn_0.w.shape[-2] * 8 for t in trainer.model.trunks] == [8, 8]
