"""command-r-plus-104b [dense]: 64L, d=12288, 96H (GQA kv=8), ff=33792,
vocab=256000, no-bias. [hf:CohereForAI/c4ai-command-r-v01]

Counterpart of ``repro/configs/command_r_plus_104b.py``.
"""

from repro_torch.configs import base

CONFIG = base.dense_lm(
    "command-r-plus-104b",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    mlp="swiglu",
    notes="Sequential pre-norm blocks (Cohere's parallel-block variant noted "
    "as a deviation in DESIGN.md).",
)

SMOKE = base.shrink(CONFIG)
