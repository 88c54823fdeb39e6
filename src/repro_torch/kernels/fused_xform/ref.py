"""Plain PyTorch versions of the fused loop-② transform.

Counterpart of ``repro/kernels/fused_xform/ref.py``: uint32 modulus →
table gather (``vocab.lookup`` semantics) ∥ ``log1p(max(f32(d), 0))``.
"""

from __future__ import annotations

import torch

from repro_torch.core.uint32 import as_u32


def _dense_xform(dense: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.clamp(dense.to(torch.float32), min=0.0))


def fused_mod_dense(
    sparse: torch.Tensor, dense: torch.Tensor, vocab_range: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """sparse int32 [rows, n_sparse]; dense [rows, n_dense]
    → (modded int32 [rows, n_sparse], dense f32 [rows, n_dense])."""
    return (as_u32(sparse) % int(vocab_range)).to(torch.int32), _dense_xform(dense)


def fused_transform(
    table: torch.Tensor, sparse: torch.Tensor, dense: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """table int32 [n_sparse, V]; sparse int32 [rows, n_sparse];
    dense [rows, n_dense] → (ids int32 [rows, n_sparse], dense f32)."""
    idx = (as_u32(sparse) % table.shape[1]).t()
    ids = torch.gather(table, 1, idx).t().contiguous()
    return ids, _dense_xform(dense)
