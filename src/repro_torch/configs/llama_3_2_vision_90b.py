"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross-attn), d=8192,
64H (GQA kv=8), ff=28672, vocab=128256. Image frontend stubbed — cross
layers attend to precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]

Counterpart of ``repro/configs/llama_3_2_vision_90b.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    superblock=(
        LayerSpec(kind="attn", attn="causal", mlp="swiglu"),
        LayerSpec(kind="attn", attn="causal", mlp="swiglu"),
        LayerSpec(kind="attn", attn="causal", mlp="swiglu"),
        LayerSpec(kind="attn", attn="causal", mlp="swiglu"),
        LayerSpec(kind="attn", attn="cross", mlp="swiglu"),
    ),
    n_superblocks=20,
    vision_tokens=1024,
    notes="100L = 20 superblocks of (4 self + 1 cross). Patch embeddings are "
    "a stub input (input_specs provides them pre-projected to d_model).",
)

SMOKE = base.shrink(CONFIG)
