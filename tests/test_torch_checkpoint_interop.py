"""Checkpoints from outside the port, read without JAX, on the CPU.

- the repository's ``seld_tpu`` checkpoint through the port's restricted
  reader, leaf for leaf and bit for bit against
  ``seld_tpu.training.checkpoint.load_checkpoint`` (also in a fresh
  interpreter that loads no JAX module), and into a port model and train
  state;
- float64: the JAX package takes three train steps and writes its
  checkpoint; the port resumes from the file for three more beside JAX's
  own three (losses, parameters and Adam moments at ``F64_TOL``), and a
  control with the moments zeroed misses that gate by >= 10x;
- the port's Trainer resumes a model directory that the JAX Trainer left
  after two epochs, and its epoch 3 matches the JAX Trainer's at 1e-4;
- the predict CLI writes the same rows from a JAX checkpoint as from a port
  checkpoint of the same weights;
- refusals: a global outside the allowlist (nothing runs), a wrong
  ``format_version``, a shape mismatch (flax paths);
- reference state dicts (``tests/torch_seld.py``) through the port's
  ``import_reference_state_dict``: the JAX importer's tree bit for bit, and
  the port model on it against the mirror in float64;
- ``chip_smoke.py``'s fixture writer read by JAX's ``load_checkpoint``
  into a ``TrainState`` of ``create_train_state``'s structure, and one JAX
  train step from it.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import pickletools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

import chip_smoke
from seld_tpu.config import load_config as jax_load_config
from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.training import Trainer as JaxTrainer
from seld_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from seld_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from seld_tpu.training.schedule import StepLRState as JaxStepLR
from seld_tpu.training.steps import TrainState as JaxTrainState
from seld_tpu.training.steps import create_train_state as jax_create_train_state
from seld_tpu.training.steps import make_optimizer as jax_make_optimizer
from seld_tpu.training.steps import make_train_step as jax_make_train_step
from seld_tpu.utils.torch_import import import_reference_state_dict as jax_import
from seld_tpu_torch import predict
from seld_tpu_torch.config import SELDConfig, load_config
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.training import (
    StepLRState, create_train_state, load_checkpoint, make_train_step, save_checkpoint,
)
from seld_tpu_torch.training.checkpoint import (
    PORT, SELD_TPU, CheckpointMismatch, checkpoint_format, load_model_weights,
)
from seld_tpu_torch.training.jax_checkpoint import read_checkpoint
from seld_tpu_torch.training.trainer import Trainer
from seld_tpu_torch.utils import import_reference_state_dict
from seld_tpu_torch.utils.jax_bridge import (
    from_jax_variables, load_jax_train_state, to_jax_variables,
)
from tests.test_torch_model import random_variables
from tests.test_torch_predict import CLI_CFG, _inputs
from tests.test_torch_training import F64_TOL, _assert_trees_close, _batch, _cfg, _port_cfg
from tests.test_trainer import _cfg as jax_trainer_cfg
from tests.torch_seld import SELDModelT

ROOT = Path(__file__).resolve().parents[1]
# written by the JAX Trainer: Q domain, CNN 8 / 8 / 8, TCN 16, 2 ResBlocks, F 16
TRACKED = (ROOT / "RESULTS_Original" / "Task2" / "seldnet_augmented"
           / "QSELD-TCN-PHI-S1_BN_RF5_2RB" / "checkpoint_best_model")


def _key(entry) -> str:
    return str(getattr(entry, "name", getattr(entry, "key", getattr(entry, "idx", entry))))


def _jax_leaves(tree) -> dict:
    """'a/b/0/c' -> leaf of a JAX pytree (dataclass and NamedTuple fields by
    name, tuple items by index)."""
    return {"/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves(tree, prefix="") -> dict:
    """The same paths over the port reader's dicts and tuples."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_leaves(v, name) if isinstance(v, (dict, tuple)) else {name: v})
    return out


def _assert_bitwise(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, np.ndarray), name
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        assert g.tobytes() == w.tobytes(), name


def _moments(state, key: str) -> dict:
    """Each parameter's torch Adam ``key`` as a nested dict at its flax path
    (zeros for a parameter that never had a gradient, as optax keeps them)."""
    tree: dict = {}
    for name, p in state.model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = state.optimizer.state[p].get(key, torch.zeros_like(p)).detach().numpy()
    return tree


def _rel_distance(got: dict, want: dict) -> float:
    """max over leaves of max|got - want| / max|want|: what
    ``_assert_trees_close`` holds to its tolerance."""
    g, w = _leaves(got), _leaves(want)
    return max(float(np.abs(np.asarray(g[k]) - w[k]).max() / max(np.abs(w[k]).max(), 1e-30))
               for k in w)


def _tracked_config(tmp_path) -> SELDConfig:
    """``tests/test_trainer.py::_cfg`` with the tracked checkpoint's widths."""
    return _port_cfg(jax_trainer_cfg(tmp_path, V=[16, 16], fc_layers=[16], use_bias_conv=False))


# a fresh interpreter reads the tracked checkpoint with the port's reader and
# prints each leaf's dtype, shape and sha256, then the JAX modules it loaded
_READ_ALONE = """
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
from seld_tpu_torch.training.jax_checkpoint import read_checkpoint

def leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, tuple)):
            yield from leaves(v, name)
        else:
            yield name, [str(v.dtype), list(v.shape), hashlib.sha256(v.tobytes()).hexdigest()]

print(json.dumps(dict(leaves(read_checkpoint(sys.argv[2])["train_state"]))))
print(" ".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "seld_tpu"))))
"""


def test_tracked_checkpoint_reads_as_jax_reads_it(tmp_path):
    got = read_checkpoint(str(TRACKED))
    jax_rng = np.random.default_rng(0)
    jstate, jloop, jsched = jax_load_checkpoint(str(TRACKED), jax_rng)
    want = _jax_leaves(jstate)
    _assert_bitwise(_leaves(got["train_state"]), want)
    proc = subprocess.run([sys.executable, "-I", "-c", _READ_ALONE, str(ROOT), str(TRACKED)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    alone, loaded = proc.stdout.split("\n")[:2]
    assert loaded == ""
    assert json.loads(alone) == {k: [str(v.dtype), list(v.shape),
                                     hashlib.sha256(v.tobytes()).hexdigest()]
                                 for k, v in want.items()}
    assert got["loop_state"] == jloop
    assert got["sched"] == dataclasses.asdict(jsched)
    assert got["np_rng_state"] == jax_rng.bit_generator.state

    cfg = _tracked_config(tmp_path)
    model = model_from_config(cfg)
    assert model.model_name == TRACKED.parent.name
    assert checkpoint_format(str(TRACKED)) == SELD_TPU
    load_model_weights(str(TRACKED), model)
    _assert_bitwise(_leaves(to_jax_variables(model)),
                    _jax_leaves({"params": jstate.params, "batch_stats": jstate.batch_stats}))

    state = create_train_state(model_from_config(cfg), cfg, torch.Generator())
    np_rng = np.random.default_rng(1)
    state, loop, sched = load_checkpoint(str(TRACKED), state, np_rng)
    assert (state.step, loop, sched) == (int(jstate.step), jloop,
                                         StepLRState(**dataclasses.asdict(jsched)))
    assert np_rng.bit_generator.state == jax_rng.bit_generator.state
    adam = jstate.opt_state.inner_state[0]
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        _assert_bitwise(_leaves(_moments(state, key)), _jax_leaves(getattr(adam, moment)))
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {float(adam.count)}
    group = state.optimizer.param_groups[0]
    hyper = jstate.opt_state.hyperparams
    assert group["lr"] == float(hyper["learning_rate"])
    assert group["betas"] == (float(hyper["b1"]), float(hyper["b2"]))
    assert group["eps"] == float(hyper["eps"])
    key = np.asarray(jstate.rng, np.uint64)
    assert state.generator.initial_seed() == int((key[0] << np.uint64(32)) | key[1])


def _jax_steps(jstep, jstate, x, y, n):
    losses = []
    for _ in range(n):
        jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return jstate, losses


def test_port_resumes_a_jax_checkpoint_in_float64(rng, tmp_path):
    cfg = _cfg()
    x, y = _batch(rng, 2)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng)
    path, control = tmp_path / "checkpoint", tmp_path / "control"
    loop = {"step": 3, "epochs": 1}
    sched = JaxStepLR(lr0=1e-3, step_size=2, gamma=0.5, min_lr=1e-5).epoch_step()
    with enable_x64(True):
        jmodel = jax_model_from_config(cfg)
        tx = jax_make_optimizer(cfg.lr)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                  variables["batch_stats"]),
                               opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        jstep = jax_make_train_step(jmodel, tx, cfg)
        jstate, _ = _jax_steps(jstep, jstate, x, y, 3)
        jax_save_checkpoint(str(path), jstate, loop, sched, np.random.default_rng(7))
        adam = jstate.opt_state.inner_state[0]
        zeroed = adam._replace(mu=jax.tree_util.tree_map(jnp.zeros_like, adam.mu),
                               nu=jax.tree_util.tree_map(jnp.zeros_like, adam.nu))
        jax_save_checkpoint(str(control), jstate.replace(opt_state=jstate.opt_state._replace(
            inner_state=(zeroed, *jstate.opt_state.inner_state[1:]))), loop, sched)
        jstate, jlosses = _jax_steps(jstep, jstate, x, y, 3)
        jstate = jax.device_get(jstate)
    jadam = jstate.opt_state.inner_state[0]

    def resume(file):
        pcfg = _port_cfg(cfg)
        state = create_train_state(model_from_config(pcfg).double(), pcfg, torch.Generator())
        state, loop_state, port_sched = load_checkpoint(str(file), state)
        assert (state.step, loop_state, port_sched) == (3, loop, StepLRState(
            **dataclasses.asdict(sched)))
        step = make_train_step(pcfg)
        losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))[1])
                  for _ in range(3)]
        tree = to_jax_variables(state.model)
        distance = max(_rel_distance(tree["params"], jstate.params),
                       _rel_distance(_moments(state, "exp_avg"), jadam.mu),
                       _rel_distance(_moments(state, "exp_avg_sq"), jadam.nu),
                       float(np.max(np.abs(np.subtract(losses, jlosses)) / np.abs(jlosses))))
        return state, losses, tree, distance

    state, losses, tree, distance = resume(path)
    np.testing.assert_allclose(losses, jlosses, rtol=F64_TOL)
    _assert_trees_close(tree["params"], jstate.params, F64_TOL)
    _assert_trees_close(tree["batch_stats"], jstate.batch_stats, F64_TOL)
    _assert_trees_close(_moments(state, "exp_avg"), jadam.mu, F64_TOL)
    _assert_trees_close(_moments(state, "exp_avg_sq"), jadam.nu, F64_TOL)
    # torch steps a parameter only where it has a gradient (the last ResBlock's
    # conv_res feeds nothing; its moments stay zero in both)
    assert state.step == 6 and {float(s["step"]) for p, s in state.optimizer.state.items()
                                if p.grad is not None} == {6.0}
    assert distance <= F64_TOL
    *_, control_distance = resume(control)
    print(f"[interop] float64 resume from a JAX checkpoint: {distance:.3e} from JAX's own "
          f"continuation, zeroed-moments control {control_distance:.3e} (gate {F64_TOL})")
    assert control_distance >= 10 * F64_TOL, control_distance


def test_port_trainer_resumes_a_jax_trainer_model_directory(tmp_path, monkeypatch, capsys):
    cfg = jax_trainer_cfg(tmp_path, dropout_perc=0.0, spatial_dropout_rate=0.0, mesh_data=1,
                          results_path="results", test_step=1, checkpoint_step=2)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "jax")
    jax_trainer = JaxTrainer(cfg, verbose=False)
    jax_trainer.setup_data()
    jax_trainer.setup_model()
    jax_trainer.fit(max_epochs=2)
    model_dir = Path("RESULTS_Original", "Task2", cfg.architecture,
                     jax_trainer.model.model_name + cfg.model_extra_name)
    shutil.copytree(model_dir, tmp_path / "port" / model_dir)
    want = jax_trainer.fit(max_epochs=3)   # the JAX Trainer's own epoch 3, resumed

    monkeypatch.chdir(tmp_path / "port")
    trainer = Trainer(_port_cfg(cfg), verbose=True, device="cpu")
    trainer.setup_data()
    trainer.setup_model()
    capsys.readouterr()
    got = trainer.fit(max_epochs=3)
    out = capsys.readouterr().out
    assert f"Resuming from {model_dir / 'checkpoint'} (seld_tpu checkpoint)" in out
    assert len(got["train_loss_hist"]) == len(want["train_loss_hist"]) == 1
    for key in ("train_loss_hist", "val_loss_hist", "train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    saved = torch.load(model_dir / "checkpoint", weights_only=True)
    assert checkpoint_format(str(model_dir / "checkpoint")) == PORT
    assert saved["loop_state"]["epochs"] == 3 and saved["sched"]["steps_taken"] == 3
    assert saved["step"] == saved["loop_state"]["step"] == 3 * 2


def test_predict_cli_reads_a_jax_checkpoint(tmp_path, rng):
    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(CLI_CFG)
    jcfg = jax_load_config(str(cfg_file))
    jmodel = jax_model_from_config(jcfg)
    variables = random_variables(jmodel, (1, 8, 256, jcfg.time_dim), rng, np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(jcfg.lr)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    jax_file, port_file = tmp_path / "jax_checkpoint", tmp_path / "port_checkpoint"
    jax_save_checkpoint(str(jax_file), jstate, {})
    cfg = load_config(str(cfg_file))
    model = model_from_config(cfg)
    from_jax_variables(variables, model)
    save_checkpoint(str(port_file), create_train_state(model, cfg, torch.Generator()), {})
    assert (checkpoint_format(str(jax_file)), checkpoint_format(str(port_file))) == (SELD_TPU,
                                                                                     PORT)
    inputs = _inputs(tmp_path, rng)
    runs = {tag: predict.main([f"--TextArgs={cfg_file}", f"--checkpoint={f}", "--inputs",
                               *inputs, f"--out-dir={tmp_path / tag}", "--impl=apply",
                               "--device=cpu"])
            for tag, f in (("jax", jax_file), ("port", port_file))}
    for a, b in zip(runs["jax"], runs["port"], strict=True):
        assert a["events"] > 0
        assert Path(a["csv"]).read_bytes() == Path(b["csv"]).read_bytes()
        np.testing.assert_array_equal(a["sed"], b["sed"])
        np.testing.assert_array_equal(a["doa"], b["doa"])


def _call_pickle(module: str, name: str, arg: str) -> bytes:
    """A protocol-2 pickle that calls ``module.name(arg)`` when loaded."""
    encoded = arg.encode()
    return (b"\x80\x02c" + f"{module}\n{name}\n".encode() + b"X"
            + len(encoded).to_bytes(4, "little") + encoded + b"\x85R.")


@pytest.mark.parametrize("module,name", [("os", "system"), ("builtins", "eval")])
def test_reader_refuses_a_global_outside_its_allowlist(tmp_path, module, name):
    assert pickle.loads(_call_pickle("builtins", "len", "abcd")) == 4   # the form calls
    canary = tmp_path / "canary"
    arg = (f"touch {canary}" if name == "system"
           else f"open({str(canary)!r}, 'w').write('ran')")
    path = tmp_path / "checkpoint"
    path.write_bytes(_call_pickle(module, name, arg))
    assert checkpoint_format(str(path)) == SELD_TPU
    with pytest.raises(pickle.UnpicklingError, match=f"refused global {module}.{name}"):
        read_checkpoint(str(path))
    with pytest.raises(pickle.UnpicklingError, match=f"refused global {module}.{name}"):
        load_model_weights(str(path), model_from_config(_tracked_config(tmp_path)))
    assert not canary.exists()


def test_reader_refuses_a_wrong_format_version_and_a_mismatch(tmp_path):
    path = tmp_path / "checkpoint"
    with open(path, "wb") as f:
        pickle.dump({"format_version": 2, "train_state": None}, f, protocol=5)
    with pytest.raises(ValueError, match="unsupported checkpoint format: 2"):
        read_checkpoint(str(path))
    cfg = _tracked_config(tmp_path).replace(G=16)
    with pytest.raises(CheckpointMismatch) as err:
        load_model_weights(str(TRACKED), model_from_config(cfg))
    assert ("shape mismatch: batch_stats/seld_block/tcn/resblock_0/bn_filter/mean config "
            "(16,) != checkpoint (8,)") in err.value.diffs
    state = create_train_state(model_from_config(cfg), cfg, torch.Generator())
    with pytest.raises(CheckpointMismatch, match="batch_stats/seld_block/tcn/resblock_0/bn_gate"):
        load_checkpoint(str(TRACKED), state)
    # an Adam moment that does not fit its parameter
    cfg = _tracked_config(tmp_path)
    tree = read_checkpoint(str(TRACKED))["train_state"]
    tree["opt_state"]["inner_state"][0]["nu"]["sed_out"]["kernel"] = np.zeros((3, 42), np.float32)
    with pytest.raises(CheckpointMismatch, match="Adam nu: shape mismatch: params/sed_out/kernel"):
        load_jax_train_state(tree, create_train_state(model_from_config(cfg), cfg,
                                                      torch.Generator()))


# the mirror's tiny shapes (tests/test_model.py::TINY), one case per topology
REF_CASES = {
    "R": dict(domain="R", cin=8),
    "Q": dict(domain="Q", cin=8),
    "DQ": dict(domain="DQ", cin=8),
    "2Parallel": dict(domain="Q", cin=8, parallel=True),
    "parallel_magphase": dict(domain="DQ", cin=16, domain_classifier="R", parallel=True,
                              magphase=True),
    "noBN": dict(domain="Q", cin=8, bn="noBN"),
    "module_prefix": dict(domain="DQ", cin=8, prefix="module."),
}


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_import_equals_jax_and_serves_as_the_mirror(case):
    kw = dict(REF_CASES[case])
    cin, prefix = kw.pop("cin"), kw.pop("prefix", "")
    domain, bn = kw["domain"], kw.get("bn", "BN")
    torch.manual_seed(list(REF_CASES).index(case))
    mirror = SELDModelT(freq=32, cin=cin, domain=domain,
                        domain_classifier=kw.get("domain_classifier", "same"),
                        filters=[8, 8, 8], pool=[[2, 2]] * 3, G=16, U=16, V=[16, 16], vk=3,
                        dilations=[1, 1, 2], fc_layers=[16], bias_conv=False, bias_linear=True,
                        bn=bn, parallel=kw.get("parallel", False),
                        magphase=kw.get("magphase", False))
    mirror.train()
    with torch.no_grad():   # running statistics off their initial values
        for _ in range(2):
            mirror(torch.randn(4, cin, 32, 32))
    mirror.eval()
    state_dict = {prefix + k: v for k, v in mirror.state_dict().items()}
    tree = import_reference_state_dict(state_dict)
    _assert_bitwise(_leaves(tree), _leaves(jax_import(state_dict)))
    assert ("batch_stats" in tree) == (bn == "BN")

    cfg = SELDConfig(domain=domain, domain_classifier=kw.get("domain_classifier", "same"),
                     input_channels=cin, freq_dim=32, time_dim=32, cnn_filters=[8, 8, 8],
                     pool_size=[[2, 2]] * 3, pool_time="TCN", D=[3], dilation_mode="fibonacci",
                     G=16, U=16, V=[16, 16], fc_layers=[16], use_bias_conv=False,
                     use_bias_linear=True, batch_norm=bn, attention_impl="full",
                     parallel_ConvTC_block="2Parallel" if kw.get("parallel") else "False",
                     parallel_magphase=kw.get("magphase", False))
    model = model_from_config(cfg).double()
    from_jax_variables(tree, model)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, cin, 32, 32)))
    with torch.no_grad():
        got, want = model(x), mirror.double()(x)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10 * float(w.abs().max()))


SIX_GLOBALS = sorted([
    "seld_tpu.training.steps TrainState", "optax._src.transform ScaleByAdamState",
    "optax._src.base EmptyState", "optax.schedules._inject InjectStatefulHyperparamsState",
    "numpy dtype", "numpy._core.numeric _frombuffer"])


def test_chip_smoke_writer_is_a_jax_checkpoint(rng, tmp_path):
    cfg = _cfg()
    pcfg = _port_cfg(cfg)
    state = create_train_state(model_from_config(pcfg, generator=torch.Generator().manual_seed(1)),
                               pcfg, torch.Generator().manual_seed(5))
    x, y = _batch(rng, 2, np.float32)
    step = make_train_step(pcfg)
    for _ in range(2):
        step(state, torch.from_numpy(x), torch.from_numpy(y))
    sched = StepLRState(lr0=1e-3, step_size=2, gamma=0.5, min_lr=1e-5).epoch_step()
    np_rng = np.random.default_rng(9)
    path = tmp_path / "checkpoint"
    chip_smoke.write_seld_tpu_checkpoint(path, state, {"step": 2, "epochs": 1}, sched,
                                         np_rng.bit_generator.state)
    named = [arg for op, arg, _ in pickletools.genops(path.read_bytes()) if op.name == "GLOBAL"]
    assert sorted(named) == SIX_GLOBALS

    jax_rng = np.random.default_rng(0)
    jstate, loop, jsched = jax_load_checkpoint(str(path), jax_rng)
    assert (loop, jsched) == ({"step": 2, "epochs": 1}, JaxStepLR(**dataclasses.asdict(sched)))
    assert jax_rng.bit_generator.state == np_rng.bit_generator.state
    jmodel = jax_model_from_config(cfg)
    made, tx = jax_create_train_state(jmodel, cfg, jax.random.PRNGKey(0), jnp.asarray(x))
    assert jax.tree_util.tree_structure(jstate) == jax.tree_util.tree_structure(made)
    for (path_, got), want in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                                  jax.tree_util.tree_leaves(made)):
        assert (got.shape, got.dtype) == (want.shape, want.dtype), path_
    _assert_bitwise(_jax_leaves({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                    _leaves(to_jax_variables(state.model)))
    adam = jstate.opt_state.inner_state[0]
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        _assert_bitwise(_jax_leaves(getattr(adam, moment)), _leaves(_moments(state, key)))
    assert int(jstate.step) == int(adam.count) == int(jstate.opt_state.count) == 2
    assert float(jstate.opt_state.hyperparams["learning_rate"]) == np.float32(pcfg.lr)

    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    jstate, loss = jax_make_train_step(jmodel, tx, cfg)(jstate, jnp.asarray(x), jnp.asarray(y))
    assert np.isfinite(float(loss)) and int(jstate.step) == 3
    assert int(jstate.opt_state.inner_state[0].count) == 3
