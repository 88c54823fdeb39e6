"""Plain PyTorch version of the DLRM per-column embedding gather and its
gradient.

Counterpart of ``repro/kernels/embedding_bag/ref.py``, and of what
``jax.grad`` makes of it. Ids follow that ref: a negative id wraps once
(``id + V``); the forward then clamps to ``[0, V-1]``, so ids ``V`` and
``V + 7`` both read row ``V-1`` (the reference's Pallas kernel fills NaN
there instead). The gradient is XLA's scatter-add transpose of that gather,
which drops an id that is still outside ``[0, V)`` after the wrap: such a
(row, column) adds nothing to the tables' gradient. Piper's ordinals are
always in range.
"""

from __future__ import annotations

import torch


def wrap_ids(ids: torch.Tensor, vocab_range: int) -> torch.Tensor:
    """int32 ids → int64, a negative id wrapped once (``id + V``)."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + vocab_range, ids)


def clamp_ids(ids: torch.Tensor, vocab_range: int) -> torch.Tensor:
    """int32 ids → the int64 rows the forward reads: wrapped, then clamped."""
    return wrap_ids(ids, vocab_range).clamp_(0, vocab_range - 1)


def embedding_gather(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables f32 [n_cols, vocab, dim]; ids int32 [batch, n_cols]
    → f32 [batch, n_cols, dim]: one embedding row per (row, column)."""
    n_cols, vocab_range, _ = tables.shape
    cols = torch.arange(n_cols, device=ids.device)[None, :]
    return tables[cols, clamp_ids(ids, vocab_range)]


def embedding_gather_backward(
    grad_out: torch.Tensor, ids: torch.Tensor, vocab_range: int, dtype=torch.float32
) -> torch.Tensor:
    """The gradient of :func:`embedding_gather` for its tables.

    grad_out f32 [batch, n_cols, dim]; ids int32 [batch, n_cols] → the dense
    ``[n_cols, vocab_range, dim]`` gradient in ``dtype``: zero everywhere,
    plus ``grad_out[b, c]`` added into row ``wrap(ids[b, c])`` of column
    ``c`` where that row is in ``[0, V)``. On the CPU ``index_add_`` adds its
    sources one after another in index order, and the sources are laid out
    column by column in ascending ``b``, so each row is a sum in ascending
    batch order. Pass ``dtype=torch.float64`` for a reference to hold a
    float32 sum to.
    """
    batch, n_cols, dim = grad_out.shape
    wrapped = wrap_ids(ids, vocab_range).t().reshape(-1)  # column by column
    rows = wrapped + torch.arange(n_cols, device=ids.device).repeat_interleave(batch) * vocab_range
    src = grad_out.to(dtype).transpose(0, 1).reshape(n_cols * batch, dim)
    keep = (wrapped >= 0) & (wrapped < vocab_range)
    grad = torch.zeros(n_cols * vocab_range, dim, dtype=dtype, device=grad_out.device)
    grad.index_add_(0, rows[keep], src[keep])
    return grad.view(n_cols, vocab_range, dim)
