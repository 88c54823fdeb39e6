"""MLP layers: gated (SwiGLU/GeGLU) and plain (GELU/ReLU²).

Counterpart of the dense half of ``repro/models/mlp.py``. The MoE layer
(``moe_init``, ``moe_forward``) comes with the rest of the model zoo
(ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params


def init(
    generator: torch.Generator | None, cfg: ModelConfig, kind: str, d_ff: int | None = None,
    *, device,
) -> Params:
    """Drawn in the reference's order of keys: up, down, then gate."""
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    p = {"up": common.dense_init(generator, d, ff, device=device),
         "down": common.dense_init(generator, ff, d, device=device)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = common.dense_init(generator, d, ff, device=device)
    return p


def forward(x: torch.Tensor, params: Params, kind: str) -> torch.Tensor:
    up = common.dense(x, params["up"])
    if kind in ("swiglu", "geglu"):
        h = common.activation(common.dense(x, params["gate"]), kind) * up
    else:
        h = common.activation(up, kind)
    return common.dense(h, params["down"])
