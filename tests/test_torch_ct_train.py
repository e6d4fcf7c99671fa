"""K9 (train-mode CNN stages 2-3) and the ``frontend_impl='pallas-ct'``
training step of the port against the JAX package, on the CPU.

- the K9 op (``conv2d_ct_bn_relu_fpool_train``, its passes' plain versions)
  against ``seld_tpu/ops/pallas/conv2d_ct_train.py::
  conv2d_widecin_ct_bn_relu_fpool_train`` in interpret mode with
  ``jax.vjp``: out, mean, var, dh, dW, dgamma, dbeta at
  ``tests/test_conv2d_ct_train.py``'s two shapes and one with Cout not a
  multiple of 8; the port in float64 on the same float32 inputs, forward
  within 2e-4 x max|ref| and gradients within 3e-4 x max|ref|, as the JAX
  package's own test holds its op;
- the op's passes (the autograd Function's CPU path) against torch autograd
  of the plain op, float64, 1e-10 x max|ref|;
- the dW pass's depth split over rows and frames (``dw_split``): every
  (b, f, t) in exactly one block's share, as many shares as partial rows;
- B1's and g_z's split (``route_split``), walked as the kernels walk it:
  every (b, channel, pooled row, frame) in one lane's quad, every partial
  slot written once; the plain routing, S_g / S_gx and g_z (the card's
  oracle) against a composition of JAX's ``_route_group`` with ties;
- one train step of a tiny model with every CNN stage on the kernel ops:
  the port in float64 against ``seld_tpu.training.steps.make_train_step``
  with ``frontend_impl='xla'`` in float64 on bridged weights (1e-9), and the
  port in float32 against the JAX model with ``'pallas-ct-interpret'`` in
  float32 (loss within 5e-5 relative, each gradient within 1e-4 relative
  norm).

Inputs are drawn by numpy from a seed and fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

from seld_tpu.models import model_from_config as jax_model_from_config
from seld_tpu.ops.pallas.conv2d_ct_train import conv2d_widecin_ct_bn_relu_fpool_train as jk9
from seld_tpu.training.loss import seld_loss as jax_seld_loss
from seld_tpu.training.steps import TrainState as JaxTrainState
from seld_tpu.training.steps import make_optimizer as jax_make_optimizer
from seld_tpu.training.steps import make_train_step as jax_make_train_step
from seld_tpu_torch.models.seld import model_from_config
from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
from seld_tpu_torch.ops.kernels import conv2d_train as k5
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from seld_tpu_torch.training import create_train_state, make_train_step, seld_loss
from seld_tpu_torch.utils.jax_bridge import from_jax_variables, to_jax_variables
from tests.test_torch_model import random_variables, tiny_config
from tests.test_torch_training import _assert_trees_close, _batch, _port_cfg

FWD_TOL, GRAD_TOL = 2e-4, 3e-4   # x max|ref|
# b, f, t, c, cout, pf: test_conv2d_ct_train.py's stage2ish and stage3ish, and
# Cout 12 (not a multiple of 8) with a ragged T
SHAPES = [(2, 16, 250, 16, 24, 8), (2, 4, 130, 16, 16, 2), (2, 8, 37, 8, 12, 4)]
NAMES = ("out", "mean", "var", "dh", "dw", "dgamma", "dbeta")


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no wrapper may count a launch."""
    reset_launch_counts()
    yield
    assert all(v == 0 for v in launch_counts.values()), launch_counts


def _case(rng, b, f, t, c, cout, pf):
    h = rng.standard_normal((b, c, f, t)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, cout)) * 0.2).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(cout)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    probe = rng.standard_normal((b, cout, f // pf, t)).astype(np.float32)
    return h, w, gamma, beta, probe


def _port(fn, h, w, gamma, beta, probe, pf):
    """The op and its gradients on float64 copies of the inputs."""
    ts = [torch.from_numpy(a).double() for a in (h, w, gamma, beta, probe)]
    leaves = [a.requires_grad_() for a in ts[:4]]
    out, mean, var = fn(*leaves, pf)
    (out * ts[4]).sum().backward()
    return [a.detach().numpy() for a in (out, mean, var, *(v.grad for v in leaves))]


@pytest.mark.parametrize("b,f,t,c,cout,pf", SHAPES)
def test_k9_matches_pallas_train_op(rng, b, f, t, c, cout, pf):
    h, w, gamma, beta, probe = _case(rng, b, f, t, c, cout, pf)
    h_ct = np.ascontiguousarray(h.transpose(0, 2, 1, 3))        # (B, F, C, T)

    def jfn(h_, w_, g_, b_):
        return jk9(h_, t, w_, g_, b_, pf, 1e-5, interpret=True)

    (out, mean, var), vjp = jax.vjp(jfn, *map(jnp.asarray, (h_ct, w, gamma, beta)))
    tpad = out.shape[-1]
    cot = np.zeros(out.shape, np.float32)                         # (B, F', Cout, tpad)
    cot[..., :t] = probe.transpose(0, 2, 1, 3)
    dh, dw, dgamma, dbeta = vjp((jnp.asarray(cot), jnp.zeros_like(mean), jnp.zeros_like(var)))
    assert tpad >= t and np.all(np.asarray(out)[..., t:] == 0.0)
    want = [np.asarray(out)[..., :t].transpose(0, 2, 1, 3), mean, var,
            np.asarray(dh).transpose(0, 2, 1, 3), dw, dgamma, dbeta]
    got = _port(k9.conv2d_ct_bn_relu_fpool_train, h, w, gamma, beta, probe, pf)
    for name, g_, w_ in zip(NAMES, got, want):
        assert np.isfinite(g_).all(), name
        _close(g_, w_, FWD_TOL if name in ("out", "mean", "var") else GRAD_TOL)


@pytest.mark.parametrize("b,f,t,c,cout,pf", SHAPES)
def test_k9_passes_match_autograd_of_the_plain_op(rng, b, f, t, c, cout, pf):
    """F1 + F2 + B1 + B2 + B3 (each pass's plain version, routed through the
    autograd Function) against torch autograd of the plain composition."""
    case = _case(rng, b, f, t, c, cout, pf)
    got = _port(k9.conv2d_ct_bn_relu_fpool_train, *case, pf)
    want = _port(k9.conv2d_ct_bn_relu_fpool_train_plain, *case, pf)
    for name, g_, w_ in zip(NAMES, got, want):
        _close(g_, w_, 1e-10)


def test_k9_rejects_what_the_kernels_do_not_take():
    h = torch.zeros(1, 12, 8, 10)   # C 12: not a multiple of 8
    s = torch.ones(4)
    with pytest.raises(ValueError):
        k9.conv2d_ct_bn_relu_fpool_train(h, torch.zeros(3, 3, 12, 4), s, s, 2)
    with pytest.raises(ValueError):   # F = 8 does not divide into pool 3
        k9.conv2d_ct_bn_relu_fpool_train(h[:, :8], torch.zeros(3, 3, 8, 4), s, s, 3)


def _dw_split_ranges(b, f, t):
    """(row0, row1, t0, t1) of each dW block in grid.x order, indexed as the
    kernels index them (``dw_split``'s docstring)."""
    rows_per_split, frames_per_split, splits = k5.dw_split(b, f, t)
    frame_splits = -(-t // frames_per_split)
    out = []
    for x in range(splits):
        r0, t0 = (x // frame_splits) * rows_per_split, (x % frame_splits) * frames_per_split
        out.append((r0, min(b * f, r0 + rows_per_split), t0, min(t, t0 + frames_per_split)))
    return out


@pytest.mark.parametrize("b,f,t", [
    (2, 32, 4800), (8, 32, 4800), (2, 4, 4800), (8, 4, 4800),   # stages 2 and 3, batch 2 / 8
    (1, 4, 1000), (2, 4, 515), (2, 24, 300), (3, 12, 777), (2, 8, 130), (1, 1, 10),
    (1, 3, 65), (1, 63, 64), (5, 13, 129),
])
def test_dw_split_covers_every_frame_once(b, f, t):
    """The dW pass's depth split (``dw_split``, the kernels' grid.x and the
    partials' row count): every (b, f, t) falls in exactly one block's share,
    frame shares are whole 64-frame steps (or all of T), and there are as
    many shares as the kernels' grid.x = ceil(B F / rows) x ceil(T / frames)."""
    rows_per_split, frames_per_split, splits = k5.dw_split(b, f, t)
    ranges = _dw_split_ranges(b, f, t)
    assert len(ranges) == splits == -(-(b * f) // rows_per_split) * -(-t // frames_per_split)
    assert splits <= 2 * k5.DW_SPLITS
    assert frames_per_split >= t or frames_per_split % k5.DW_FRAME_STEP == 0
    seen = np.zeros((b * f, t), np.int64)
    for r0, r1, t0, t1 in ranges:
        assert r0 < r1 and t0 < t1
        seen[r0:r1, t0:t1] += 1
    assert (seen == 1).all()


def _route_walk_cover(b, cout, f_out, t, pf, sms, blocks_per_sm):
    """Walk route_split's units as the kernels do (route_walk in
    csrc/conv3x3_ct_train.cu): warp w of block k takes units w * blocks + k,
    then every ROUTE_WARPS * blocks-th after; lane l of a unit's span takes
    the quads of frames from span start + 4 l in steps of 128 * kG, as kG
    quads 128 frames apart (kG 2 at pf <= 4). Returns (frames seen per (b,
    channel, pooled row, frame), writes per partial slot (row, channel),
    partial rows)."""
    frames_per_span, spans, blocks = k9.route_split(b, cout, f_out, t, sms, blocks_per_sm)
    kg = 2 if pf <= 4 else 1
    quad = k9.ROUTE_QUAD
    units = b * cout * f_out * spans
    rows = b * f_out * spans
    seen = np.zeros((b * cout * f_out, t), np.int64)
    slots = np.zeros((rows, cout), np.int64)
    for warp in range(k9.ROUTE_WARPS):
        for block in range(blocks):
            for u in range(warp * blocks + block, units, k9.ROUTE_WARPS * blocks):
                span, window = u % spans, u // spans
                fo, bc = window % f_out, window // f_out
                t_first = span * frames_per_span
                t_end = min(t, t_first + frames_per_span)
                lanes = t_first + quad * np.arange(32)
                steps = np.arange(lanes[0], t_end, quad * 32 * kg) - lanes[0]
                starts = (lanes[:, None, None] + steps[None, :, None]
                          + quad * 32 * np.arange(kg)[None, None, :]).ravel()
                starts = starts[starts < t_end]
                frames = (starts[:, None] + np.arange(quad)).ravel()
                np.add.at(seen[window], frames[frames < t], 1)
                slots[(bc // cout * f_out + fo) * spans + span, bc % cout] += 1
    return seen, slots, rows


@pytest.mark.parametrize("kernel", sorted(k9.ROUTE_BLOCKS_PER_SM))
@pytest.mark.parametrize("b,cout,f,t,pf,sms", [
    (2, 192, 32, 4800, 8, 132), (2, 192, 4, 4800, 2, 132),   # stages 2 and 3, batch 2
    (8, 192, 4, 4800, 2, 132), (2, 24, 32, 4800, 16, 132),   # stage 3 at batch 8; pf 16
    (2, 8, 16, 1, 1, 132), (1, 6, 16, 3, 16, 132), (2, 12, 8, 130, 2, 132),
    (3, 5, 16, 515, 8, 132), (2, 40, 16, 515, 1, 7), (1, 72, 4, 1000, 2, 3),
    (2, 16, 32, 4800, 8, 5),   # few SMs: several rounds of units
])
def test_route_split_covers_every_frame_once(b, cout, f, t, pf, sms, kernel):
    """B1's and g_z's split (``route_split``, the kernels' spans, grid and
    partial rows): walked as the kernels walk it, every (b, channel, pooled
    row, frame) falls in exactly one lane's quad, every partial slot (row,
    channel) is written exactly once, the partials have B * F' * spans rows,
    and the grid is at most the card's resident blocks."""
    f_out, per_sm = f // pf, k9.ROUTE_BLOCKS_PER_SM[kernel]
    frames_per_span, spans, blocks = k9.route_split(b, cout, f_out, t, sms, per_sm)
    assert frames_per_span % k9.ROUTE_QUAD == 0 and spans == -(-t // frames_per_span)
    assert 1 <= blocks <= sms * per_sm
    seen, slots, rows = _route_walk_cover(b, cout, f_out, t, pf, sms, per_sm)
    assert rows == b * f_out * spans
    assert (seen == 1).all()
    assert (slots == 1).all()


@pytest.mark.parametrize("pf,t", [(1, 130), (3, 37), (3, 130), (16, 515)])
def test_route_plain_matches_jax_route_group_with_ties(rng, pf, t):
    """The card's oracle (``ct_sel_stats_plain``, ``ct_gz_plain``) against
    a composition of JAX's ``_route_group`` on the same float32 rows, at T %
    4 != 0 and with ties: pre on an integer grid ties the max of most
    windows, scale and bias on grids make pre * scale + bias exact. The
    routed g_pre is equal bit for bit; S_g / S_gx and g_z (scale * (g_pre -
    c1 - xhat * c2), xhat = (pre - mean) * inv) within 1e-6 x max."""
    from seld_tpu.ops.pallas.conv2d_ct_train import _route_group

    b, cout, windows = 2, 5, 3
    f = pf * windows
    pre = rng.integers(-3, 4, (b, cout, f, t)).astype(np.float32)
    g = rng.standard_normal((b, cout, windows, t)).astype(np.float32)
    cols = np.stack([rng.integers(4, 13, cout) / 8, rng.integers(-4, 5, cout) / 8,
                     0.1 * rng.standard_normal(cout), 1.0 + 0.1 * rng.standard_normal(cout),
                     1e-2 * rng.standard_normal(cout),
                     1e-2 * rng.standard_normal(cout)]).astype(np.float32)
    g_pre = np.zeros_like(pre)
    for bi in range(b):
        for fo in range(windows):
            rows = [jnp.asarray(pre[bi, :, fo * pf + r]) for r in range(pf)]
            routed = _route_group(rows, jnp.asarray(cols[0][:, None]),
                                  jnp.asarray(cols[1][:, None]), jnp.asarray(g[bi, :, fo]))
            for r, (want, _) in enumerate(routed):
                g_pre[bi, :, fo * pf + r] = np.asarray(want)
    y = np.maximum(pre * cols[0][:, None, None] + cols[1][:, None, None], 0).reshape(
        b, cout, windows, pf, t)
    ties = ((y == y.max(axis=3, keepdims=True)).sum(axis=3) > 1) & (y.max(axis=3) > 0)
    assert pf == 1 or ties.sum() > ties.size // 20   # ties in many routed windows
    tp = lambda a: torch.from_numpy(a)
    got, _ = k9._route_plain(tp(pre), tp(g), tp(cols), pf)
    np.testing.assert_array_equal(got.numpy(), g_pre)
    col = lambda i: cols[i][:, None, None].astype(np.float64)
    xhat = (pre - col(2)) * col(3)
    sums = np.concatenate([g_pre.sum((0, 2, 3), dtype=np.float64),
                           (g_pre * xhat).sum((0, 2, 3))])
    _close(k9.ct_sel_stats_plain(tp(pre), tp(g), tp(cols), pf).numpy(), sums, 1e-6)
    gz = col(0) * (g_pre - col(4) - xhat * col(5))
    _close(k9.ct_gz_plain(tp(pre), tp(g), tp(cols), pf).numpy(), gz, 1e-6)


def test_route_skips_nan_windows_as_jax(rng):
    """The pool gradient's routing (``_route_plain``, which B1 and B2 share)
    against JAX's ``_route_group`` on the same float32 rows: a pool window
    holding a NaN in row 0 or in a later row routes nothing, and every
    finite window routes as before, bit for bit; S_g counts only routed
    windows (g = 1) and S_gx is NaN in a channel with a NaN, as JAX's sum of
    g_pre * xhat."""
    from seld_tpu.ops.pallas.conv2d_ct_train import _route_group

    b, cout, pf, windows, t = 1, 6, 4, 3, 40
    f = pf * windows
    pre = rng.standard_normal((b, cout, f, t)).astype(np.float32)
    g = rng.standard_normal((b, cout, windows, t)).astype(np.float32)
    cols = np.stack([1.0 + 0.2 * rng.standard_normal(cout), 0.3 * rng.standard_normal(cout),
                     0.1 * rng.standard_normal(cout), 1.0 + 0.1 * rng.standard_normal(cout),
                     np.zeros(cout), np.zeros(cout)]).astype(np.float32)
    nans = [(0, 0, 3), (1, 2, 5), (2, 3, 7), (4, 5, 9)]   # (channel, row, frame): row 0 and later
    for c, r, tt in nans:
        pre[0, c, r, tt] = np.nan
    g_pre, _ = k9._route_plain(*map(torch.from_numpy, (pre, g, cols)), pf)
    g_pre = g_pre.numpy()
    for fo in range(windows):
        rows = [jnp.asarray(pre[0, :, fo * pf + r]) for r in range(pf)]
        routed = _route_group(rows, jnp.asarray(cols[0][:, None]), jnp.asarray(cols[1][:, None]),
                              jnp.asarray(g[0, :, fo]))
        for r, (want, _) in enumerate(routed):
            np.testing.assert_array_equal(g_pre[0, :, fo * pf + r], np.asarray(want))
    for c, r, tt in nans:   # nothing routed in the windows that hold a NaN
        fo = r // pf
        assert not g_pre[0, c, fo * pf:(fo + 1) * pf, tt].any()
    assert np.count_nonzero(g_pre) > windows * cout * t // 2   # the finite windows route
    sel = k9.ct_sel_stats_plain(*map(torch.from_numpy, (pre, np.ones_like(g), cols)), pf).numpy()
    finite = np.isfinite(pre).all(axis=(0, 2, 3))
    assert np.isfinite(sel[:cout]).all() and (np.isnan(sel[cout:]) == ~finite).all()
    routed_windows = (g_pre != 0).sum(axis=(0, 2, 3))   # g = 1 routes a one where g_pre != 0
    np.testing.assert_array_equal(sel[:cout], routed_windows)


# ---- the pallas-ct training step ----------------------------------------------

def _ct_cfg(**kw):
    """tiny_config (CNN 8 / 16, stage pools 2 and 2, Cin 8, bias-free convs, BN
    on) with dropout off: every CNN stage meets the K5/K9 conditions."""
    base = dict(dropout_perc=0.0, spatial_dropout_rate=0.0, lr=1e-3)
    base.update(kw)
    return tiny_config(**base)


def test_ct_train_steps_match_jax_plain_stages(rng):
    """Three float64 steps, port 'pallas-ct' (K5 + K9 on their plain versions)
    against the JAX package's 'xla' stages: losses, parameters, BN stats."""
    cfg = _ct_cfg(frontend_impl="xla")
    x, y = _batch(rng, 2)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng)
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
        for _ in range(3):
            jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
            jlosses.append(float(loss))
        jstate = jax.device_get(jstate)
    pcfg = _port_cfg(cfg).replace(frontend_impl="pallas-ct")
    model = model_from_config(pcfg).double()
    assert model.seld_block.frontend_impl == "ct"
    from_jax_variables(variables, model)
    state = create_train_state(model, pcfg, torch.Generator().manual_seed(0))
    step = make_train_step(pcfg)
    plosses = []
    for _ in range(3):
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y))
        plosses.append(float(loss))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-9)
    tree = to_jax_variables(model)
    _assert_trees_close(tree["params"], jstate.params, 1e-9)
    _assert_trees_close(tree["batch_stats"], jstate.batch_stats, 1e-9)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def test_ct_train_step_f32_matches_jax_pallas_ct_interpret(rng):
    """float32: the port's 'pallas-ct' forward and backward against the JAX
    model with its K5 and K9 Pallas ops in interpret mode."""
    cfg = _ct_cfg(frontend_impl="pallas-ct-interpret")
    x, y = _batch(rng, 2, np.float32)
    variables = random_variables(jax_model_from_config(cfg), x.shape, rng, np.float32)
    jmodel = jax_model_from_config(cfg)

    def loss_fn(params):
        (sed, doa), _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(x), train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_seld_loss(sed, doa, jnp.asarray(y))

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = model_from_config(_port_cfg(cfg))
    assert model.seld_block.frontend_impl == "ct"
    from_jax_variables(variables, model)
    sed, doa = model(torch.from_numpy(x), train=True)
    loss = seld_loss(sed, doa, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=5e-5)
    want = dict(_flat(jax.device_get(jgrads)))
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) <= set(want) and len(got) >= len(want) - 1   # the last conv_res feeds nothing
    for name, g in got.items():
        rel = np.linalg.norm(g - want[name]) / max(np.linalg.norm(want[name]), 1e-30)
        assert rel <= 1e-4, (name, rel)


def test_ct_frontend_warns_and_runs_the_plain_stages_on_the_cpu(rng):
    """'pallas-ct' with biased convs (the kernels' convs are bias-free): on the
    CPU the plain stages run, with a warning, and give the 'xla' model's loss
    (a CUDA tensor raises: tests/test_torch_cuda.py)."""
    x, y = (torch.from_numpy(a) for a in _batch(rng, 2))
    losses = []
    for impl in ("pallas-ct", "xla"):
        pcfg = _port_cfg(_ct_cfg(use_bias_conv=True, frontend_impl=impl))
        model = model_from_config(pcfg, generator=torch.Generator().manual_seed(1)).double()
        if impl == "pallas-ct":
            with pytest.warns(UserWarning, match="K5/K9 conditions"):
                sed, doa = model(x, train=True)
        else:
            sed, doa = model(x, train=True)
        losses.append(float(seld_loss(sed, doa, y).detach()))
    assert losses[0] == losses[1]
