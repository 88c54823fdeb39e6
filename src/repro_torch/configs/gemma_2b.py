"""gemma-2b [dense]: 18L, d=2048, 8H (MQA kv=1), head_dim=256, ff=16384,
vocab=256000, GeGLU, tied embeddings. [arXiv:2403.08295]

Counterpart of ``repro/configs/gemma_2b.py``.
"""

from repro_torch.configs import base

CONFIG = base.dense_lm(
    "gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
)

SMOKE = base.shrink(CONFIG, n_kv_heads=1)
