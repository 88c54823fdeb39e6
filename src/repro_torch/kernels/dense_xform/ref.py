"""Plain PyTorch version of the dense transform.

Counterpart of ``repro/kernels/dense_xform/ref.py``: Neg2Zero then
Logarithm, ``log1p(max(f32(x), 0))``.
"""

from __future__ import annotations

import torch


def dense_transform(dense: torch.Tensor) -> torch.Tensor:
    """dense int32/f32 [rows, n_dense] → f32 [rows, n_dense]."""
    return torch.log1p(torch.clamp(dense.to(torch.float32), min=0.0))
