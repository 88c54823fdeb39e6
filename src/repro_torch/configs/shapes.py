"""The assigned input-shape set + per-(arch × shape) applicability.

Counterpart of ``repro/configs/shapes.py``:

  train_4k     seq 4096,   global_batch 256  → train_step
  prefill_32k  seq 32768,  global_batch 32   → prefill (forward) step
  decode_32k   seq 32768,  global_batch 128  → serve_step (1 new token,
                                               KV cache of seq_len)
  long_500k    seq 524288, global_batch 1    → serve_step; sub-quadratic
               archs only (SSM state / ring caches). Pure full-attention
               archs skip it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per brief)"
        )
    return True, ""
