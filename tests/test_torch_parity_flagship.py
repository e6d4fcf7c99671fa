"""Ladder rung 2 for the port: the full flagship in float64 at the clip shape
(1, 8, 256, 4800), held inside PARITY.md's chaos control. The port's
counterpart of ``tools/parity_flagship.py``'s ``PARITY_F64=1`` mode.

The reference-named mirror (``tests/torch_seld.py``) is built at the
flagship's widths, its BN running statistics moved off their initial values
by one train-mode pass, and cast to float64. Its state dict goes through the
port's ``utils/torch_import.py::import_reference_state_dict`` into the port's
model of ``config/DQSELD-TCN-S1-PHI_8ch.txt``. The chaos control is the
mirror's own spread under a one-part-in-1e13 input perturbation
(``tools/parity_flagship.py:125-141``): a cross-implementation residual at
or below it is conditioning, not an implementation difference.

- ``test_port_flagship_inside_the_mirror_chaos_control``: the port against
  the mirror; torch only, so it also runs where JAX is not installed
  (``--noconftest``);
- ``test_port_flagship_inside_the_chaos_control_against_jax``: the port
  against the JAX package's flagship on the same imported tree (skips
  without JAX, flax or optax).

Both are ``slow``: a few GiB, and about half a minute of the torch leg on 8 CPU cores.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from seld_tpu_torch.config import load_config
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.utils import import_reference_state_dict
from seld_tpu_torch.utils.jax_bridge import from_jax_variables
from tests.torch_seld import SELDModelT

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP_CONFIG = ROOT / "config" / "DQSELD-TCN-S1-PHI_8ch.txt"
SHAPE = (1, 8, 256, 4800)
PERTURBATION = 1e-13
FLOOR = 1e-12   # the gate where the envelope reads 0 (tools/parity_flagship.py)


def _stats(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got - want)
    return {"max": float(d.max()), "p99.9": float(np.quantile(d, 0.999)),
            "median": float(np.median(d))}


@pytest.fixture(scope="module")
def flagship():
    """The mirror's outputs on x and on x * (1 + 1e-13), its state dict
    through the port's importer, the port's outputs on x, and wall times."""
    torch.manual_seed(0)
    seconds = {}
    t0 = time.perf_counter()
    mirror = SELDModelT(
        freq=256, cin=8, domain="DQ", domain_classifier="DQ", filters=[192, 192, 192],
        pool=[[8, 2], [8, 2], [2, 2]], G=384, U=384, V=[384, 384], vk=3,
        dilations=[1, 1, 2, 3, 5, 8, 13, 21, 34, 55], fc_layers=[384], bias_conv=False,
        bias_linear=True, bn="BN")
    rng = np.random.default_rng(0)
    mirror.train()
    with torch.no_grad():
        mirror(torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)))
    mirror = mirror.eval().double()
    x = rng.standard_normal(SHAPE)
    with torch.no_grad():
        ref = [a.numpy() for a in mirror(torch.from_numpy(x))]
        t1 = time.perf_counter()
        perturbed = [a.numpy() for a in mirror(torch.from_numpy(x * (1.0 + PERTURBATION)))]
        seconds["mirror forward"] = time.perf_counter() - t1
    tree = import_reference_state_dict(mirror.state_dict())
    seconds["mirror, with its warm-up pass"] = time.perf_counter() - t0
    del mirror

    model = model_from_config(load_config(str(FLAGSHIP_CONFIG))).double().eval()
    from_jax_variables(tree, model)
    t1 = time.perf_counter()
    with torch.no_grad():
        port = [a.numpy() for a in model(torch.from_numpy(x))]
    seconds["port forward"] = time.perf_counter() - t1
    return {"x": x, "ref": ref, "perturbed": perturbed, "tree": tree, "port": port,
            "seconds": seconds}


def _gate(tag: str, got: list, flagship: dict) -> None:
    """Each head's max|got - mirror| within the mirror's own envelope."""
    for name, g, ref, pert in zip(("SED", "DOA"), got, flagship["ref"], flagship["perturbed"],
                                  strict=True):
        assert g.shape == ref.shape and np.isfinite(g).all()
        d, env = _stats(g, ref), _stats(pert, ref)
        print(f"[rung 2] {tag} {name}: max|d| {d['max']:.3e} p99.9 {d['p99.9']:.3e} median "
              f"{d['median']:.3e}; the mirror's 1e-13 envelope max|d| {env['max']:.3e} p99.9 "
              f"{env['p99.9']:.3e}")
        assert d["max"] <= max(env["max"], FLOOR), (tag, name, d, env)


def test_port_flagship_inside_the_mirror_chaos_control(flagship):
    print(f"[rung 2] wall seconds {flagship['seconds']}")
    _gate("port vs mirror", flagship["port"], flagship)


def test_port_flagship_inside_the_chaos_control_against_jax(flagship):
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")   # the JAX package's model
    pytest.importorskip("optax")
    from jax._src.config import enable_x64

    from __graft_entry__ import _flagship_model

    t0 = time.perf_counter()
    with enable_x64(True):
        import jax.numpy as jnp

        model = _flagship_model(time_dim=SHAPE[-1])
        tree = flagship["tree"]

        @jax.jit
        def forward(variables, x):
            with jax.default_matmul_precision("highest"):
                return model.apply(variables, x, train=False)

        sed, doa = forward({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                           jnp.asarray(flagship["x"]))
        jax_out = [np.asarray(sed), np.asarray(doa)]
    print(f"[rung 2] JAX forward, its compile included: {time.perf_counter() - t0:.1f} s")
    _gate("JAX vs mirror", jax_out, flagship)
    for name, g, j, ref, pert in zip(("SED", "DOA"), flagship["port"], jax_out, flagship["ref"],
                                     flagship["perturbed"], strict=True):
        d, env = _stats(g, j), _stats(pert, ref)
        print(f"[rung 2] port vs JAX {name}: max|d| {d['max']:.3e} (envelope {env['max']:.3e})")
        assert d["max"] <= max(env["max"], FLOOR), (name, d, env)
