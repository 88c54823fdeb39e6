"""gemma-7b [dense]: 28L, d=3072, 16H (kv=16), head_dim=256, ff=24576,
vocab=256000, GeGLU, tied embeddings. [arXiv:2403.08295]

Counterpart of ``repro/configs/gemma_7b.py``.
"""

from repro_torch.configs import base

CONFIG = base.dense_lm(
    "gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
)

SMOKE = base.shrink(CONFIG)
