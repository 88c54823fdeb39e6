"""qwen2-moe-a2.7b [moe]: 24L, d=2048, 16H (kv=16), vocab=151936,
MoE 60 routed top-4 (d_expert_ff=1408) + 4 shared. QKV bias.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

Counterpart of ``repro/configs/qwen2_moe_a2_7b.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    superblock=(LayerSpec(kind="attn", attn="causal", mlp="swiglu", moe=True),),
    n_superblocks=24,
    moe=MoEConfig(
        n_experts=60, top_k=4, d_expert_ff=1408, n_shared=4, d_shared_ff=1408
    ),
    use_qkv_bias=True,
)

SMOKE = base.shrink(CONFIG)
