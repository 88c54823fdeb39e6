"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro/configs/__init__.py``, every architecture of the
reference: the dense, MoE, SSM and hybrid decoder-only families, the
vision LM (cross-attention to patch embeddings) and the audio
encoder-decoder. ``get(arch_id)`` → the full ``ModelConfig``;
``get_smoke`` → the reduced config for CPU tests. ``piper_dlrm`` is the tabular workload
and is imported on its own.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

# arch id → module name
_MODULES = {
    "whisper-small": "whisper_small",
    "command-r-plus-104b": "command_r_plus_104b",
    "minitron-8b": "minitron_8b",
    "gemma-2b": "gemma_2b",
    "gemma-7b": "gemma_7b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
