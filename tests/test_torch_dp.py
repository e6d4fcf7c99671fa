"""Data-parallel training of the port across processes, on the CPU.

Two worker processes, spawned by the test under timeouts, form a ``gloo``
group (``seld_tpu_torch.parallel.multihost.initialize``) and run float64
train steps of a tiny DQ model on their rows of a global batch of 4:

- ``make_train_step(cfg, mesh)`` through K5's plain path (``frontend_impl``
  'fused'), through K5's and K9's (``pallas-ct``), each with the TCN's BN,
  with dropout off and on, and with gradient accumulation: within 1e-12 of
  the one-process step at the global batch (the accumulation case on the
  global batch's rows in the order its microbatches take them), and, dropout
  off, within the port's float64 tolerance (1e-9) of the JAX package's
  single-device step (its plain stages, bridged weights);
- a batch whose ranks hold 2 and 1 rows: gathered and computed whole on
  each rank (``multihost.global_batch``), within 1e-12 of one process;
- ``parallel.make_dp_train_step`` (per-rank BN) against JAX's
  ``make_dp_train_step`` on a 2-device CPU mesh, float64, dropout off;
- the multihost helpers (``allgather_rows`` with unequal rows,
  ``shard_for_host``, ``barrier``) and the reduction hook's all-reduces, by
  site.

Then the train CLI from a ``.seldpak`` file as two ranks (``JAX_*``
variables) beside one process: both ranks log the same losses and metrics
as the one process, and one set of checkpoint files is written.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seld_tpu_torch.config import SELDConfig
from seld_tpu_torch.data.synthetic import make_task2_batch
from seld_tpu_torch.models.layers import BatchNorm
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.training import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
F64_TOL = 1e-9        # the port against the JAX package in float64 (tests/test_torch_training.py)
RANKS_TOL = 1e-12     # two ranks against one process, both the port, float64
STEPS, GLOBAL_BATCH = 2, 4
WORKER_TIMEOUT_S = 240
# tag -> the config's overrides; every case runs STEPS steps at GLOBAL_BATCH
CASES = {
    "fused": dict(frontend_impl="pallas"),
    "ct": dict(frontend_impl="pallas-ct"),
    "ct_dropout": dict(frontend_impl="pallas-ct", dropout_perc=0.3, spatial_dropout_rate=0.5),
    "fused_accum": dict(frontend_impl="pallas", grad_accum_steps=2),
    "xla_dropout": dict(frontend_impl="xla", dropout_perc=0.3, spatial_dropout_rate=0.5),
}
JAX_CASES = ("fused", "ct")   # dropout off: held to the JAX step too


def tiny_cfg(**kw) -> SELDConfig:
    """``tests/test_torch_model.tiny_config`` in the port's config: F = T = 32,
    CNN 8 / 16 (3 * Cin <= 32, widths a multiple of 8: K5 and K9 take every
    stage), two ResBlocks with BN, G = U = 8; dropout off, lr 1e-3."""
    base = dict(domain="DQ", domain_classifier="same", input_channels=8, freq_dim=32,
                time_dim=32, cnn_filters=[8, 16], pool_size=[[2, 2], [2, 2], [2, 2]],
                pool_time="TCN", D=[2], G=8, U=8, V=[16, 16], fc_layers=[16],
                attention_impl="full", use_bias_conv=False, use_bias_linear=True,
                dropout_perc=0.0, spatial_dropout_rate=0.0, lr=1e-3, batch_size=GLOBAL_BATCH)
    base.update(kw)
    return SELDConfig(**base)


def tiny_model(cfg) -> torch.nn.Module:
    """Seeded float64 weights, with every BN's scale, bias and running
    statistics moved off their defaults so each of them matters."""
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(0)).double()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.scale.shape[0]
                m.scale.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    return model


def global_batch(n=GLOBAL_BATCH, seed=2):
    x, y = make_task2_batch(np.random.default_rng(seed), n, channels=8, freq=32,
                            time_frames=32, label_frames=4)
    return x.astype(np.float64), y.astype(np.float64)


def run_steps(cfg, x, y, mesh=None, sharded=True):
    """STEPS steps from :func:`tiny_model` on (x, y); returns (losses, the
    model's state dict as numpy)."""
    model = tiny_model(cfg)
    state = create_train_state(model, cfg, torch.Generator().manual_seed(3))
    step = make_train_step(cfg, mesh)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y), sharded)
        losses.append(float(loss))
    return losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def accum_order(n=GLOBAL_BATCH, ranks=2, accum=2):
    """The global batch's rows in the order one process's microbatches take
    them: microbatch i holds every rank's i-th share of its rows."""
    local = n // ranks
    share = local // accum
    return [r * local + i * share + j for i in range(accum) for r in range(ranks)
            for j in range(share)]


# ---- the worker: one rank of the two ------------------------------------------

def worker(rank: int, port: int, out: str) -> None:
    """One rank: every case on its rows of the global batch, the whole-batch
    case, the per-rank-BN step and the helpers; results to ``out`` (npz)."""
    from seld_tpu_torch.parallel import make_dp_train_step, make_mesh, multihost
    from seld_tpu_torch.parallel import replicate_state, shard_batch

    torch.set_num_threads(2)
    assert multihost.initialize(f"localhost:{port}", 2, rank, device="cpu", timeout_s=120)
    assert multihost.process_info() == (rank, 2)
    mesh = make_mesh(-1)
    assert mesh.shape == {"data": 2, "model": 1}
    res = {}
    x, y = global_batch()
    for tag, kw in CASES.items():
        cfg = tiny_cfg(**kw)
        xs, ys = shard_batch(mesh, x, y)
        losses, sd = run_steps(cfg, xs.numpy(), ys.numpy(), mesh)
        res[f"{tag}/losses"] = np.array(losses)
        res.update({f"{tag}/{k}": v for k, v in sd.items()})
    res["hook_counts"] = json.dumps(dict(mesh.cross_rank.counts))

    # ranks holding 2 and 1 rows: the batch is gathered and computed whole
    x3, y3 = global_batch(3, seed=4)
    rows = slice(0, 2) if rank == 0 else slice(2, 3)
    (xt, yt), sharded = multihost.global_batch(mesh, x3[rows], y3[rows],
                                               device=torch.device("cpu"))
    assert not sharded and xt.shape[0] == 3
    losses, sd = run_steps(tiny_cfg(frontend_impl="pallas-ct"), xt.numpy(), yt.numpy(), mesh,
                           sharded=False)
    res["whole/losses"] = np.array(losses)
    res.update({f"whole/{k}": v for k, v in sd.items()})

    # the explicit step: per-rank BN statistics, the state from rank 0
    cfg = tiny_cfg(frontend_impl="xla")
    model = tiny_model(cfg)
    if rank == 1:   # replicate_state must bring rank 0's weights
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    state = replicate_state(create_train_state(model, cfg, torch.Generator().manual_seed(3)),
                            mesh)
    xs, ys = shard_batch(mesh, x, y)
    dp_step = make_dp_train_step(cfg, mesh)
    losses = []
    for _ in range(STEPS):
        state, loss = dp_step(state, xs, ys)
        losses.append(float(loss))
    res["dp/losses"] = np.array(losses)
    res.update({f"dp/{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()})

    # the helpers
    local = np.arange(6, dtype=np.float64).reshape(3, 2)[: 2 - rank] + 10 * rank
    np.testing.assert_array_equal(multihost.allgather_rows(local),
                                  np.array([[0, 1], [2, 3], [10, 11]], np.float64))
    assert multihost.shard_for_host(8) == (4, 4 * rank, 4 * rank + 4)
    multihost.barrier("worker done")
    np.savez(out, **res)
    multihost.shutdown()


def free_ports(n: int) -> list:
    """``n`` distinct free TCP ports (bound at once, then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start(cmds, cwds, envs, logs) -> list:
    """Start every command at once, each in its directory with its
    environment, its output to its log file (no pipe to fill while the test
    computes)."""
    procs = []
    for cmd, cwd, env, log in zip(cmds, cwds, envs, logs):
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, cwd=cwd, env=env, stdout=f,
                                           stderr=subprocess.STDOUT), log))
    return procs


def finish(procs, timeout=WORKER_TIMEOUT_S) -> list:
    """Wait for every process of :func:`start` under ``timeout`` (killed past
    it); returns their (returncode, output)."""
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, Path(log).read_text()) for p, log in procs]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two workers and the train CLI's three runs (two ranks, one
    process) from a .seldpak file, all started at once; the JAX references
    are computed while they run."""
    from seld_tpu_torch.data.native import pack_dataset
    from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset

    tmp = tmp_path_factory.mktemp("dp")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    port, cli_port = free_ports(2)
    code = ("import sys; from tests.test_torch_dp import worker; "
            f"worker(int(sys.argv[1]), {port}, sys.argv[2])")
    workers = start([[sys.executable, "-c", code, str(r), str(tmp / f"rank{r}.npz")]
                     for r in range(2)], [ROOT, ROOT], [env, env],
                    [tmp / f"rank{r}.log" for r in range(2)])

    paths = gen_fake_task2_dataset(str(tmp / "data"), n_train=8, n_val=4, n_test=4,
                                   channels=8, freq=16, time_frames=16, label_frames=2)
    pak = pack_dataset(SELDConfig(
        training_predictors_path=paths["train"][0], training_target_path=paths["train"][1],
        validation_predictors_path=paths["validation"][0],
        validation_target_path=paths["validation"][1],
        test_predictors_path=paths["test"][0], test_target_path=paths["test"][1]),
        str(tmp / "data" / "task2.seldpak"))
    cmd = [sys.executable, "-m", "seld_tpu_torch.train", f"--TextArgs={_cli_config(tmp, pak)}",
           "--max_epochs=2", "--device=cpu"]
    envs = [{**env, "JAX_COORDINATOR_ADDRESS": f"localhost:{cli_port}",
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r)} for r in range(2)] + [env]
    dirs = [tmp / "ranks", tmp / "ranks", tmp / "one"]
    for d in dirs:
        d.mkdir(exist_ok=True)
    cli = start([cmd] * 3, dirs, envs, [tmp / f"cli{i}.log" for i in range(3)])
    yield {"tmp": tmp, "workers": workers, "cli": cli, "pak": pak}
    for p, _ in workers + cli:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(launched, jax_single_device, jax_dp):
    """The two workers' results, rank 0's and rank 1's."""
    tmp = launched["tmp"]
    for r, (rc, out) in enumerate(finish(launched["workers"])):
        assert rc == 0, f"rank {r} failed ({rc}):\n{out[-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what}: {k}")


def _case(res: dict, tag: str) -> tuple:
    losses = res[f"{tag}/losses"]
    sd = {k.split("/", 1)[1]: v for k, v in res.items()
          if k.startswith(tag + "/") and k != f"{tag}/losses"}
    return losses, sd


@pytest.mark.parametrize("tag", list(CASES))
def test_two_ranks_equal_one_process_at_the_global_batch(ranks, tag):
    x, y = global_batch()
    cfg = tiny_cfg(**CASES[tag])
    if cfg.grad_accum_steps > 1:
        order = accum_order(accum=cfg.grad_accum_steps)
        x, y = x[order], y[order]
    want_losses, want = run_steps(cfg, x, y)
    for r, res in enumerate(ranks):
        losses, sd = _case(res, tag)
        np.testing.assert_allclose(losses, want_losses, rtol=RANKS_TOL, err_msg=f"rank {r}")
        _close(sd, want, RANKS_TOL, f"rank {r}")
    assert want_losses[-1] < want_losses[0]


def test_a_batch_that_does_not_split_is_computed_whole(ranks):
    x, y = global_batch(3, seed=4)
    want_losses, want = run_steps(tiny_cfg(frontend_impl="pallas-ct"), x, y)
    for r, res in enumerate(ranks):
        losses, sd = _case(res, "whole")
        np.testing.assert_allclose(losses, want_losses, rtol=RANKS_TOL, err_msg=f"rank {r}")
        _close(sd, want, RANKS_TOL, f"rank {r}")


def test_the_hook_sums_k5_k9_and_every_bn_over_the_ranks(ranks):
    counts = json.loads(str(ranks[0]["hook_counts"]))
    assert counts == json.loads(str(ranks[1]["hook_counts"]))
    # per step of each case (forward and backward): K5 (F1, B1) in 'fused' 1,
    # 'ct' 1, 'ct_dropout' 1, 'fused_accum' 2 (two microbatches), 'xla_dropout'
    # none; K9 (stage 2) in the two 'ct' cases; BatchNorm: six TCN layers a
    # microbatch, plus the plain stage 2 in 'fused' (twice in 'fused_accum') and
    # both CNN stages in 'xla_dropout': 7 + 6 + 6 + 14 + 8; the gradients once a case
    assert counts["K5 F1"] == counts["K5 B1"] == 5 * STEPS
    assert counts["K9 F1"] == counts["K9 B1"] == 2 * STEPS
    assert counts["BN"] == counts["BN grad"] == 41 * STEPS
    assert counts["grads"] == len(CASES) * STEPS


def _jax_cfg(cfg):
    from seld_tpu.config import SELDConfig as JaxSELDConfig

    fields = JaxSELDConfig.field_names()
    return JaxSELDConfig(**{k: getattr(cfg, k) for k in SELDConfig.field_names() if k in fields})


def _jax_state(jcfg, model, x):
    import jax
    import jax.numpy as jnp

    from seld_tpu.models import model_from_config as jax_model_from_config
    from seld_tpu.training.steps import TrainState, make_optimizer
    from seld_tpu_torch.utils.jax_bridge import to_jax_variables

    variables = to_jax_variables(model)
    jmodel = jax_model_from_config(jcfg)
    tx = make_optimizer(jcfg.lr)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
    return jmodel, tx, state


def _jax_result(jstate, cfg):
    """The JAX state's variables in the port's state-dict names."""
    import jax

    from seld_tpu_torch.utils.jax_bridge import from_jax_variables

    model = tiny_model(cfg)
    from_jax_variables(jax.device_get({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}), model)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_single_device(launched):
    """The JAX package's single-device step at the global batch: its plain
    stages, from the same weights, float64."""
    import jax
    import jax.numpy as jnp
    from jax._src.config import enable_x64

    from seld_tpu.training.steps import make_train_step as jax_make_train_step

    cfg = tiny_cfg(frontend_impl="xla")
    x, y = global_batch()
    with enable_x64(True):
        jmodel, tx, state = _jax_state(_jax_cfg(cfg), tiny_model(cfg), x)
        step = jax_make_train_step(jmodel, tx, _jax_cfg(cfg))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        state = jax.device_get(state)
    return losses, _jax_result(state, cfg)


@pytest.mark.parametrize("tag", JAX_CASES)
def test_two_ranks_equal_the_jax_single_device_step(ranks, jax_single_device, tag):
    want_losses, want = jax_single_device
    for r, res in enumerate(ranks):
        losses, sd = _case(res, tag)
        np.testing.assert_allclose(losses, want_losses, rtol=F64_TOL, err_msg=f"rank {r}")
        _close(sd, want, F64_TOL, f"rank {r}")


@pytest.fixture(scope="module")
def jax_dp(launched):
    """JAX's ``make_dp_train_step`` on a 2-device CPU mesh from the same
    weights, float64, dropout off: (losses, variables in the port's names)."""
    import jax
    import jax.numpy as jnp
    from jax._src.config import enable_x64

    from seld_tpu.parallel.dp_step import make_dp_train_step, replicate_state
    from seld_tpu.parallel.mesh import make_mesh, shard_batch

    cfg = tiny_cfg(frontend_impl="xla")
    x, y = global_batch()
    with enable_x64(True):
        jmodel, tx, state = _jax_state(_jax_cfg(cfg), tiny_model(cfg), x)
        mesh = make_mesh(2, 1, devices=jax.devices()[:2])
        step = make_dp_train_step(jmodel, tx, _jax_cfg(cfg), mesh)
        state = replicate_state(state, mesh)
        xb, yb = shard_batch(mesh, jnp.asarray(x), jnp.asarray(y))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, xb, yb)
            losses.append(float(loss))
        state = jax.device_get(state)
    return losses, _jax_result(state, cfg)


def test_dp_step_equals_the_jax_dp_step_on_a_two_device_mesh(ranks, jax_dp):
    losses, want = jax_dp
    for r, res in enumerate(ranks):
        got_losses, sd = _case(res, "dp")
        np.testing.assert_allclose(got_losses, losses, rtol=F64_TOL, err_msg=f"rank {r}")
        _close(sd, want, F64_TOL, f"rank {r}")
    # per-rank statistics: not the global batch's step
    _, global_sd = _case(ranks[0], "xla_dropout")
    assert not np.allclose(ranks[0]["dp/seld_block.tcn.resblock_0.bn_pre.var"],
                           global_sd["seld_block.tcn.resblock_0.bn_pre.var"])


# ---- the train CLI as two ranks ------------------------------------------------

CLI_LINES = ("epoch ", "TEST epoch", "train_loss ", "val_loss ", "test_loss ")


def _cli_config(tmp_path, pak: str) -> Path:
    lines = ["--domain=Q", "--input_channels=8", "--freq_dim=16", "--time_dim=16",
             "--n_mics=2", "--batch_size=4", "--lr=0.001", "--num_frames=2", "--test_step=1",
             "--checkpoint_step=2", "--min_n_epochs=1", "--patience=1000",
             "--attention_impl=full", "--pool_time=TCN", "--cnn_filters=[8,8,8]",
             "--pool_size=[[2,2],[2,2],[2,2]]", "--D=[2]", "--G=8", "--U=8", "--V=[8,8]",
             "--fc_layers=[8]", "--use_bias_conv=False", "--results_path=results",
             f"--training_predictors_path={pak}"]
    path = tmp_path / "cli.txt"
    path.write_text("\n".join(lines) + "\n")
    return path


def _log_lines(text: str) -> list:
    """The epoch, test and result lines, each epoch's time cut off."""
    out = []
    for line in text.splitlines():
        if line.startswith(CLI_LINES):
            out.append(line.split(" (")[0] if line.startswith("epoch ") else line)
    return out


def test_train_cli_as_two_ranks_from_a_seldpak_file(launched):
    from seld_tpu_torch.data.native import PakReader
    from seld_tpu_torch.training.checkpoint import ROLES

    with PakReader(launched["pak"]) as reader:
        assert [reader.shape(i)[0] for i in range(6)] == [8, 8, 4, 4, 4, 4]
    done = finish(launched["cli"])
    for (rc, out), tag in zip(done, ("rank 0", "rank 1", "one process")):
        assert rc == 0, f"{tag} failed ({rc}):\n{out[-4000:]}"
    assert "multihost: process 0/2 on cpu" in done[0][1]
    assert "multihost: process 1/2 on cpu" in done[1][1]
    rank0, rank1, one = (_log_lines(out) for _, out in done)
    assert rank0 == rank1, (rank0, rank1)
    assert len([line for line in rank0 if line.startswith("epoch ")]) == 2
    assert len(rank0) == len(one)
    for a, b in zip(rank0, one):   # one process at the global batch logs the same numbers
        assert _words(a) == _words(b), (a, b)
        for (va, da), (vb, _) in zip(_numbers(a), _numbers(b), strict=True):
            assert abs(va - vb) <= 10.0 ** -da + 1e-5 * abs(vb), (a, b)
    # one set of files: rank 0 writes them, rank 1 none
    ranks_dir = launched["tmp"] / "ranks"
    model_dirs = list((ranks_dir / "RESULTS_Original").glob("Task2/*/*"))
    assert len(model_dirs) == 1, model_dirs
    for f in ROLES.values():
        assert (model_dirs[0] / f).is_file(), f
    records = (model_dirs[0] / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["epoch"] for r in records] == [1, 2]
    csv = next(model_dirs[0].glob("*_training_metrics.csv")).read_text().splitlines()
    assert len(csv) == 2
    assert (ranks_dir / "results" / "results_dict.json").is_file()


def _words(line: str) -> list:
    return [w for w in line.split() if not _number(w)]


def _numbers(line: str) -> list:
    """(value, decimals printed) of every number on a log line."""
    return [(float(w), len(w.split(".")[1]) if "." in w else 0) for w in line.split()
            if _number(w)]


def _number(text: str) -> bool:
    try:
        float(text)
        return True
    except ValueError:
        return False
