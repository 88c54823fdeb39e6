"""Per-architecture runtime assembly for the launchers.

Counterpart of ``repro/launch/specs.py::build_model``. The reference's
lowering cells (``build_cell``, ``batch_specs`` and their shardings) come
with the dry-run (ROADMAP queue 1 item 10).
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
) -> lm_lib.LM:
    """The ``LM`` of ``cfg`` on ``device``; the audio family's ``EncDec``
    is not ported and raises."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (audio) family comes with cross-attention "
            "(ROADMAP queue 1 item 10, slice 18)")
    return lm_lib.LM(cfg, remat=remat, attn_impl=attn_impl, attn_block_k=attn_block_k,
                     ce_block=ce_block, device=device)
