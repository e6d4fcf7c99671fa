"""Hamilton-product block-weight assembly (torch).

Counterpart of ``seld_tpu/ops/hamilton.py``. A quaternion layer stores its 4
real components stacked on axis 0; the effective real weight is the 4x4
block matrix of signed components, built here in the JAX package's
feature-last orientation ``(..., Cin, Cout)`` (conv kernels ``(*k, Cin,
Cout)``, linear weights ``(Cin, Cout)``). Modules permute to torch's ``(Cout,
Cin, *k)`` only where they call a torch op.

Reference quirk kept for parity (``seld_tpu/ops/hamilton.py:21-29``): the DQ
*linear* weight uses the transposed Hamilton table with its zero block at
(in_primary, out_dual), while the DQ *conv* weight uses the standard table
with its zero block at (in_dual, out_primary).
"""

from __future__ import annotations

import torch

# T[out_block][in_block] = (component_index, sign): the conv-orientation table.
Q_TABLE = (
    ((0, +1), (1, -1), (2, -1), (3, -1)),
    ((1, +1), (0, +1), (3, -1), (2, +1)),
    ((2, +1), (3, +1), (0, +1), (1, -1)),
    ((3, +1), (2, -1), (1, +1), (0, +1)),
)


def _block_rows(comps: torch.Tensor, table, transpose: bool) -> torch.Tensor:
    """(in_block, out_block) grid of signed components -> (..., 4cin, 4cout).

    Entry [a][b] is T[b][a] (standard operator applied from the right), or
    T[a][b] with ``transpose``."""
    rows = []
    for a in range(4):
        cols = []
        for b in range(4):
            idx, sgn = table[a][b] if transpose else table[b][a]
            cols.append(comps[idx] if sgn > 0 else -comps[idx])
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=-2)


def assemble_q_kernel(comps: torch.Tensor) -> torch.Tensor:
    """Quaternion weight: comps (4, ..., cin, cout) -> (..., 4cin, 4cout)."""
    return _block_rows(comps, Q_TABLE, transpose=False)


def assemble_dq_conv_kernel(comps: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion conv weight: comps (8, ..., cin, cout) -> (..., 8cin, 8cout).

    W[in<4, out<4] = Q, W[in<4, out>=4] = Q_e, W[in>=4, out<4] = 0,
    W[in>=4, out>=4] = Q."""
    q = _block_rows(comps[:4], Q_TABLE, transpose=False)
    qe = _block_rows(comps[4:], Q_TABLE, transpose=False)
    top = torch.cat([q, qe], dim=-1)
    bot = torch.cat([torch.zeros_like(q), q], dim=-1)
    return torch.cat([top, bot], dim=-2)


def assemble_dq_linear_kernel(comps: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion *linear* weight (reference-quirk orientation):
    W[in<4, out<4] = Q', W[in<4, out>=4] = 0, W[in>=4, out<4] = Q_e',
    W[in>=4, out>=4] = Q', with Q'[a][b] = T[a][b]."""
    q = _block_rows(comps[:4], Q_TABLE, transpose=True)
    qe = _block_rows(comps[4:], Q_TABLE, transpose=True)
    top = torch.cat([q, torch.zeros_like(q)], dim=-1)
    bot = torch.cat([qe, q], dim=-1)
    return torch.cat([top, bot], dim=-2)
