"""minitron-8b [dense]: 32L, d=4096, 32H (GQA kv=8), ff=16384, vocab=256000.
Pruned Nemotron-4: squared-ReLU MLP. [arXiv:2407.14679]

Counterpart of ``repro/configs/minitron_8b.py``.
"""

from repro_torch.configs import base

CONFIG = base.dense_lm(
    "minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp="relu2",
)

SMOKE = base.shrink(CONFIG)
