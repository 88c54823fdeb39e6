"""Plain PyTorch versions of the per-op vocabulary kernels.

Counterpart of ``repro/kernels/vocab/ref.py``, in the same transposed
``[n_cols, rows]`` layout (one column per row of the state or table):

``apply_vocab``      — ApplyVocab-2: per-column table gather.
``genvocab``         — GenVocab-1: scatter-min of first-occurrence positions.
``genvocab_counts``  — the optional count plane beside it: one per row
                       below the ceiling (the reference adds it outside its
                       kernel, in ``kernels/vocab/ops.py``).

Each returns a new tensor; the CUDA kernels update in place.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib


def apply_vocab(table: torch.Tensor, vals_t: torch.Tensor) -> torch.Tensor:
    """table int32 [n_cols, vocab_range]; vals_t int32 [n_cols, rows]
    → ids int32 [n_cols, rows] (take-along-axis)."""
    return torch.gather(table, 1, vals_t.to(torch.int64))


def genvocab(state: torch.Tensor, vals_t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter-min of positions into per-column first-occurrence tables.

    state  int32 [n_cols, vocab_range]
    vals_t int32 [n_cols, rows] — modded values
    pos    int32 [rows]        — global row positions (NEVER for invalid)
    """
    idx = vals_t.to(torch.int64)
    return state.scatter_reduce(1, idx, pos[None, :].expand_as(idx), reduce="amin")


def genvocab_counts(counts: torch.Tensor, vals_t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """counts int32 [n_cols, vocab_range] plus one at each (column, value)
    of a row whose position is below NEVER (valid and below the ceiling)."""
    idx = vals_t.to(torch.int64)
    inc = (pos < vocab_lib.NEVER).to(torch.int32)
    return counts.scatter_add(1, idx, inc[None, :].expand_as(idx))
