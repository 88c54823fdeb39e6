"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro/configs/__init__.py`` for the architectures the
port runs. ``get(arch_id)`` → the full ``ModelConfig``; ``get_smoke`` →
the reduced config for CPU tests. ``piper_dlrm`` is the tabular workload
and is imported on its own.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

# arch id → module name; the reference's other nine architectures come with
# the rest of the model zoo (ROADMAP queue 1 item 10)
_MODULES = {
    "gemma-2b": "gemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported (known: {sorted(_MODULES)}); the reference's "
            "other architectures come with the rest of the model zoo (ROADMAP queue 1 item 10)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
