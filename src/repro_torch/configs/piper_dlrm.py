"""The paper's own workload config: Piper preprocessing + DLRM training on
the Criteo schema (1 label + 13 dense + 26 sparse), at vocab 5K and 1M
(the two memory tiers the paper evaluates).

Counterpart of ``repro/configs/piper_dlrm.py``. The reference builds its
``PipelineConfig`` when the module is imported; the port's defaults to
``device="cuda"`` and raises without a card, so each config here holds the
schema and the ``DLRMConfig`` and builds its pipeline config in
:meth:`PiperDLRMConfig.pipeline_config`, for a device the caller names.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import schema as schema_lib
from repro_torch.models.dlrm import DLRMConfig


@dataclasses.dataclass(frozen=True)
class PiperDLRMConfig:
    name: str
    schema: schema_lib.TableSchema
    model: DLRMConfig

    def pipeline_config(self, *, device="cuda", **fields) -> pipeline_lib.PipelineConfig:
        """The pipeline of this workload on ``device``; ``fields`` set any
        other ``PipelineConfig`` field."""
        return pipeline_lib.PipelineConfig(schema=self.schema, device=device, **fields)


def _make(name: str, vocab_range: int) -> PiperDLRMConfig:
    return PiperDLRMConfig(
        name=name,
        schema=dataclasses.replace(schema_lib.CRITEO, vocab_range=vocab_range),
        model=DLRMConfig(vocab_range=vocab_range),
    )


CONFIG_5K = _make("piper-dlrm-5k", 5_000)
CONFIG_1M = _make("piper-dlrm-1m", 1_000_000)
SMOKE = _make("piper-dlrm-smoke", 257)
