"""The reduction hook of a data-parallel train step: batch statistics summed
over every rank.

Under the JAX Trainer's data mesh, GSPMD computes a step at the global batch:
each BatchNorm normalizes with the statistics of every rank's rows
(``tests/test_sharding.py:49``; across processes ``tests/test_multihost.py:162``).
The port runs one process per device, so a train-mode step under a process
group passes a :class:`CrossRank` down the model's forward
(``SELDModel.forward(..., cross_rank=...)``) to the three places where batch
statistics are formed:

- K5 (``ops/kernels/conv2d_train.py``): F1's per-channel sums before the
  float64 statistics are formed, and B1's sums before the g_z pass;
- K9 (``ops/kernels/conv2d_ct_train.py``): the same two pairs of sums;
- ``models/layers.BatchNorm`` (the TCN's, and the CNN stages' plain path): the
  sum and the sum of squares, through :meth:`CrossRank.sum_differentiable`,
  whose backward sums the gradient over the ranks too.

The kernels do not change: the all-reduce sits between their passes, and the
plain versions take the same hook. The hook also gives each rank its rows of
the global batch (:meth:`CrossRank.rows`), which the dropouts use to take
their rows of the mask one process would draw at the global batch.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist


class CrossRank:
    """Sums tensors over the ranks of ``group`` (the default group if None).
    ``counts`` holds the all-reduces made through it, by site."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("CrossRank needs an initialized process group "
                               "(seld_tpu_torch.parallel.multihost.initialize)")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.counts: Counter = Counter()

    def sum(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """A new tensor: ``t`` summed over the ranks (not differentiable)."""
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.counts[site] += 1
        return out

    def sum_differentiable(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """``t`` summed over the ranks; its backward sums the incoming
        gradient over the ranks (every rank's loss depends on every rank's
        ``t``)."""
        return _AllReduceSum.apply(t, self, site)

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * world`` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, hook, site):
        ctx.hook, ctx.site = hook, site
        return hook.sum(t, site)

    @staticmethod
    def backward(ctx, g):
        return ctx.hook.sum(g, ctx.site + " grad"), None, None
