"""Shared model layers.

Counterpart of ``repro/models/common.py``, ported as far as the DLRM uses
it: ``dense_init`` / ``dense`` become the :class:`Dense` module. The
language-model layers (norms, RoPE, attention projections) come with the
language-model path.
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ w + b`` in the JAX package's layout: ``w [d_in, d_out]``,
    ``b [d_out]`` (not ``nn.Linear``'s ``[out, in]``), so weights carry
    across packages without a transpose.

    ``w`` is drawn from ``generator`` as ``normal · d_in**-0.5`` and ``b``
    is zero, as ``dense_init(..., bias=True)`` does. With
    ``generator=None`` the weights are left uninitialised, for a caller
    that loads them (``interop.dlrm_params_from_numpy``, a checkpoint).
    """

    def __init__(
        self, d_in: int, d_out: int, *, device="cuda", generator: torch.Generator | None = None
    ):
        super().__init__()
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
        if generator is not None:
            w.normal_(generator=generator).mul_(d_in**-0.5)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b
