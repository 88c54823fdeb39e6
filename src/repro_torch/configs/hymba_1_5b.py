"""hymba-1.5b [hybrid]: 32L, d=1600, 25H (GQA kv=5), ff=5504, vocab=32001,
ssm_state=16. Parallel attention + mamba heads per layer; 2 global-attn
layers, rest sliding-window (1024). Sub-quadratic decode (ring caches +
SSM state) — runs long_500k. [arXiv:2411.13676]

Counterpart of ``repro/configs/hymba_1_5b.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig, SSMConfig

_SWA = 1024

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    superblock=tuple(
        [LayerSpec(kind="hymba", window=0, mlp="swiglu")]  # global layer
        + [LayerSpec(kind="hymba", window=_SWA, mlp="swiglu") for _ in range(7)]
    ),
    n_superblocks=4,
    ssm=SSMConfig(kind="mamba", d_state=16, d_inner=1600, chunk=128),
    sub_quadratic=True,
    notes="Global full attention every 8th layer (4 of 32; the release uses "
    "3: first/middle/last — one extra global layer keeps the scanned "
    "superblock compile-sized). Meta-tokens not modeled.",
)

SMOKE = base.shrink(CONFIG, n_kv_heads=2, n_heads=4)
