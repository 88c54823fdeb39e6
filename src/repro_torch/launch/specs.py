"""Per-architecture runtime assembly for the launchers.

Counterpart of ``repro/launch/specs.py::build_model``. The reference's
lowering cells (``build_cell``, ``batch_specs`` and their shardings) come
with the dry-run (ROADMAP queue 1 item 10, slice 20).
"""

from __future__ import annotations

from repro_torch.models import lm as lm_lib
from repro_torch.models.common import ModelConfig


def build_model(
    cfg: ModelConfig,
    attn_impl: str = "chunked",
    remat: bool = True,
    attn_block_k: int = 1024,
    ce_block: int = 512,
    device="cuda",
) -> lm_lib.LM | lm_lib.EncDec:
    """The model of ``cfg`` on ``device``: ``EncDec`` for the audio family,
    else ``LM``."""
    model = lm_lib.EncDec if cfg.family == "audio" else lm_lib.LM
    return model(cfg, remat=remat, attn_impl=attn_impl, attn_block_k=attn_block_k,
                 ce_block=ce_block, device=device)
