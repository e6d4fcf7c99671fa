"""The explicit data-parallel train step, with per-rank batch statistics.

The port's counterpart of ``seld_tpu/parallel/dp_step.py``
(``make_dp_train_step``, ``replicate_state``), the alternative to the
Trainer's step (``training/steps.py``, which under a mesh computes the
global batch's statistics as GSPMD does): each rank steps on its own rows
with the BatchNorm statistics of those rows only, draws dropout masks of its
own, and then the gradients, the loss and the BN running statistics are
averaged over the ranks. This is torch ``DataParallel``'s per-replica BN
(the reference's vestigial DP path, reference train.py:27-66): the running
means match global-batch training (equal shards), the running variances
differ by the spread of the shards' means.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from seld_tpu_torch import disable_tf32
from seld_tpu_torch.models.layers import BatchNorm
from seld_tpu_torch.training.steps import TrainState, _input, _loss_fn, average_over_ranks

_SEED_MASK = (1 << 63) - 1


def step_seed(state: TrainState, rank: int) -> int:
    """The seed of rank ``rank``'s dropout draws at ``state.step``: the
    state's seed with the step and the rank folded in (as the JAX step folds
    ``axis_index('data')`` into its key), so ranks draw apart and the
    state's own generator never advances."""
    seed = state.generator.initial_seed()
    for v in (state.step, rank):
        seed = (seed * 0x9E3779B97F4A7C15 + v + 1) & _SEED_MASK
    return seed


def make_dp_train_step(cfg, mesh):
    """Returns ``train_step(state, x, y) -> (state, loss)`` on ``mesh``'s
    data axis: x and y are this rank's rows, the state is replicated
    (:func:`replicate_state`) and stays so."""
    if cfg.compute_dtype == "float32":
        disable_tf32()
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in ('float32', 'bfloat16')")
    cross_rank = mesh.cross_rank
    if cross_rank is None:
        raise ValueError("make_dp_train_step needs a data axis of more than one rank")
    loss_of = _loss_fn(cfg)

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        gen = torch.Generator(device=state.generator.device)
        gen.manual_seed(step_seed(state, cross_rank.rank))
        state.optimizer.zero_grad(set_to_none=True)
        sed, doa = state.model(_input(cfg, x), train=True, generator=gen)
        loss = loss_of(sed, doa, y)
        loss.backward()
        loss = average_over_ranks(state.model.parameters(), loss.detach(), cross_rank)
        bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
        if bns:   # the running statistics: the mean over the ranks
            stats = [b for m in bns for b in (m.mean, m.var)]
            flat = cross_rank.sum(torch.cat([b.reshape(-1) for b in stats]), "BN running")
            flat /= cross_rank.world
            offset = 0
            for b in stats:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


@torch.no_grad()
def replicate_state(state: TrainState, mesh) -> TrainState:
    """Rank 0's parameters, buffers and optimizer moments on every rank."""
    if mesh.n_data > 1:
        tensors = list(state.model.parameters()) + list(state.model.buffers())
        for s in state.optimizer.state.values():
            tensors += [v for v in s.values() if torch.is_tensor(v) and v.dim() > 0]
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
    return state
