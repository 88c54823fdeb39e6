"""Plain PyTorch version of the fused loop-① state update.

Counterpart of ``repro/kernels/fused_vocab/ref.py``: the unfused chain
the kernel replaces — uint32 modulus, positions as ``vocab.positions``
computes them, scatter-min into ``first_pos`` and, when tracked, the
count increment of every row below the ceiling. It has the kernel's
calling convention: the state is updated **in place** and the advanced
``rows_seen`` is returned.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.core.uint32 import as_u32


def fused_genvocab(
    first_pos: torch.Tensor,
    counts: torch.Tensor | None,
    sparse: torch.Tensor,
    valid: torch.Tensor,
    rows_seen: torch.Tensor,
) -> torch.Tensor:
    """first_pos int32 [n_cols, V] and counts int32 [n_cols, V] | None,
    updated in place; sparse int32 [rows, n_cols] (raw hashes); valid bool
    [rows]; rows_seen int32 [] → the advanced rows_seen."""
    rows = sparse.shape[0]
    pos = vocab_lib.positions(rows_seen, rows, valid)
    idx = (as_u32(sparse) % first_pos.shape[1]).t()  # [n_cols, rows]
    first_pos.scatter_reduce_(1, idx, pos[None, :].expand_as(idx), reduce="amin")
    if counts is not None:
        inc = (pos < vocab_lib.NEVER).to(torch.int32)
        counts.scatter_add_(1, idx, inc[None, :].expand_as(idx))
    return vocab_lib.advance_rows_seen(rows_seen, valid.to(torch.int32).sum())
