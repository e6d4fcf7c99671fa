"""Train and eval steps.

Counterpart of ``seld_tpu/training/steps.py``. A step runs the model in
train mode (batch-statistics BN, dropout from the state's generator), the
SELD loss, the backward and one Adam update with torch's defaults
(``betas=(0.9, 0.999)``, ``eps=1e-8``: the same update as optax's ``adam``).
PyTorch updates in place: the state's model, optimizer and generator carry
the step's effects, and ``train_step`` returns the same state object with
the loss.

The input is cast to ``cfg.compute_dtype`` (bfloat16 runs every layer in
bfloat16 against float32 master weights, as the JAX package's bf16 mode
does); float32 runs with TF32 off, the counterpart of the JAX package's
'highest' matmul precision. On a CUDA device the training path's kernels
run: K5 (CNN stage 0, ``frontend_impl`` 'auto') and K4 + K6 (attention at
T >= 1024 in bfloat16, or ``attention_impl='flash'``).

``grad_accum_steps > 1`` splits a batch that divides into that many equal
microbatches, run in order: BN normalizes per microbatch with running
statistics chained through them, dropout draws fresh masks for each, and
the gradients are averaged into one update (a batch that does not divide
runs as one).

Under data parallelism (``make_train_step(cfg, mesh)`` with a data axis of
more than one rank, ``parallel/mesh.py``) each rank passes its rows of the
global batch and the step is the one-process step at the global batch, as
GSPMD makes the JAX Trainer's: every batch statistic is summed over the
ranks (the mesh's ``cross_rank`` hook reaches K5, K9 and every BatchNorm),
each dropout mask is this rank's rows of the mask one process would draw at
the global batch (the ranks' generators agree), and after the backward the
gradients and the loss are averaged over the ranks in one all-reduce before
``optimizer.step()``. With accumulation, microbatch i of the global batch
is every rank's i-th share of its rows. A batch passed with
``sharded=False`` (the whole global batch on every rank,
``multihost.global_batch``'s remainder) runs as one process would run it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from seld_tpu_torch import disable_tf32
from seld_tpu_torch.models.seld import SELDModel
from seld_tpu_torch.training.loss import seld_loss

_COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class TrainState:
    model: SELDModel
    optimizer: torch.optim.Adam
    generator: torch.Generator   # dropout draws, on the model's device
    step: int = 0


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam with the reference's torch-default hyperparameters."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: SELDModel, cfg, generator: torch.Generator) -> TrainState:
    """A state around ``model`` (already built and placed): Adam at
    ``cfg.lr`` and ``generator`` for the dropout masks."""
    return TrainState(model, make_optimizer(model.parameters(), cfg.lr), generator)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def _loss_fn(cfg):
    def loss(sed, doa, y):
        return seld_loss(sed, doa, y, output_classes=cfg.output_classes,
                         class_overlaps=int(cfg.class_overlaps),
                         sed_weight=cfg.sed_loss_weight, doa_weight=cfg.doa_loss_weight)
    return loss


def _input(cfg, x: torch.Tensor) -> torch.Tensor:
    """x in the step's compute dtype (float64 input stays float64)."""
    return x.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" else x


def average_over_ranks(params, loss: torch.Tensor, cross_rank) -> torch.Tensor:
    """Average every gradient of ``params`` and ``loss`` over the ranks of
    ``cross_rank`` in one all-reduce of a flat buffer; returns the averaged
    loss. Every rank's parameters must have gradients alike."""
    grads = [p.grad for p in params if p.grad is not None]
    dtype = grads[0].dtype if grads else loss.dtype
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads]
                     + [loss.reshape(1).to(dtype)])
    flat = cross_rank.sum(flat, "grads") / cross_rank.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].to(loss.dtype)


def make_train_step(cfg, mesh=None):
    """Returns ``train_step(state, x, y, sharded=True) -> (state, loss)``; x
    (B, C, F, T), y (B, T', 4 * classes * overlaps). The loss is a detached
    0-d tensor (the mean over microbatches when accumulating). With a
    ``mesh`` of more than one rank, x and y are this rank's rows of the
    global batch (``sharded``) or the whole global batch (``sharded=False``),
    and the loss is the global batch's."""
    if cfg.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in {_COMPUTE_DTYPES}")
    if cfg.compute_dtype == "float32":
        disable_tf32()
    accum = max(int(getattr(cfg, "grad_accum_steps", 1) or 1), 1)
    loss_of = _loss_fn(cfg)
    cross_rank = mesh.cross_rank if mesh is not None else None

    def forward_backward(state: TrainState, x, y, hook) -> torch.Tensor:
        sed, doa = state.model(_input(cfg, x), train=True, generator=state.generator,
                               cross_rank=hook)
        loss = loss_of(sed, doa, y)
        loss.backward()
        return loss.detach()

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   sharded: bool = True):
        hook = cross_rank if sharded else None
        state.optimizer.zero_grad(set_to_none=True)
        b = x.shape[0]
        if accum > 1 and b % accum == 0:
            losses = [forward_backward(state, xi, yi, hook)
                      for xi, yi in zip(x.chunk(accum), y.chunk(accum))]
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = torch.stack(losses).mean()
        else:
            loss = forward_backward(state, x, y, hook)
        if cross_rank is not None:
            loss = average_over_ranks(state.model.parameters(), loss, cross_rank)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


def make_eval_step(cfg):
    """Returns ``eval_step(state, x, y) -> loss``: eval-mode BN and no
    dropout, no gradient, nothing updated."""
    loss_of = _loss_fn(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sed, doa = state.model(_input(cfg, x), train=False)
        return loss_of(sed, doa, y)

    return eval_step


def make_infer_step(cfg):
    """Returns ``infer_step(model, x) -> (sed, doa)``: the eval-mode forward
    (running BN statistics, no dropout) in the step's compute dtype, without
    gradients."""

    @torch.no_grad()
    def infer_step(model: SELDModel, x: torch.Tensor):
        return model(_input(cfg, x), train=False)

    return infer_step
