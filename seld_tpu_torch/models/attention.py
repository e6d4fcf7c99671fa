"""Multi-head self-attention over the time axis (torch).

Counterpart of ``seld_tpu/models/attention.py``: bias-free ``values`` /
``keys`` / ``queries`` Dense projections, the head split channel-major
(channel c goes to head c // head_dim), scores scaled by 1/sqrt(head_dim),
softmax over keys with no mask, and a biased ``fc_out``.

``impl``: ``'full'`` (one softmax over all keys), ``'chunked'`` (the same
math over query chunks, memory O(chunk * T)), ``'flash'`` (the K4 kernel,
``ops/kernels/attention.py``), or ``'auto'`` (chunked from T = 1024 on, else
full; the plain model never picks the kernel itself).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from seld_tpu_torch.models.layers import Dense
from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_plain

IMPLS = ("auto", "full", "chunked", "flash")
CHUNK = 512  # queries per chunk of the 'chunked' path, as in the JAX module


def attend_full(q, k, v, scale: float) -> torch.Tensor:
    """(N, T, H, D) softmax attention, as ``_attend_full`` with no mask."""
    return flash_attention_plain(q, k, v, scale)[0]


def attend_chunked(q, k, v, scale: float, chunk: int) -> torch.Tensor:
    """Exact attention one query chunk at a time."""
    return torch.cat(
        [attend_full(q[:, i:i + chunk], k, v, scale) for i in range(0, q.shape[1], chunk)],
        dim=1,
    )


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_size: int, num_heads: int = 8, impl: str = "auto", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_size % num_heads:
            raise ValueError("Embedding size must be divisible by number of heads")
        if impl not in IMPLS:
            raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
        self.embed_size, self.num_heads = embed_size, num_heads
        self.impl = impl
        kw = dict(device=device, generator=generator)
        self.values = Dense(embed_size, embed_size, use_bias=False, **kw)
        self.keys = Dense(embed_size, embed_size, use_bias=False, **kw)
        self.queries = Dense(embed_size, embed_size, use_bias=False, **kw)
        self.fc_out = Dense(embed_size, embed_size, use_bias=True, **kw)

    def forward(self, v, k, q, impl: Optional[str] = None):
        """v, k, q (N, T, E) -> (N, T, E); ``impl`` overrides the module's."""
        head_dim = self.embed_size // self.num_heads
        n, t = q.shape[0], q.shape[1]

        def proj(x, dense):
            return dense(x).reshape(x.shape[0], x.shape[1], self.num_heads, head_dim)

        vh, kh, qh = proj(v, self.values), proj(k, self.keys), proj(q, self.queries)
        scale = 1.0 / (head_dim ** 0.5)
        impl = impl or self.impl
        if impl == "auto":
            impl = "chunked" if t >= 1024 else "full"
        if impl == "flash":
            out = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), scale)[0]
        elif impl == "chunked":
            out = attend_chunked(qh, kh, vh, scale, CHUNK)
        else:
            out = attend_full(qh, kh, vh, scale)
        return self.fc_out(out.reshape(n, t, self.embed_size))
