"""kimi-k2-1t-a32b [moe]: 61L, d=7168, 64H (GQA kv=8), vocab=163840,
MoE 384 experts top-8 (d_expert_ff=2048) + 1 shared. Trillion-param MoE.
[arXiv:2501.kimi2]

Counterpart of ``repro/configs/kimi_k2_1t_a32b.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,  # per-expert ff (assignment's d_ff)
    vocab_size=163840,
    superblock=(LayerSpec(kind="attn", attn="causal", mlp="swiglu", moe=True),),
    n_superblocks=61,
    moe=MoEConfig(
        n_experts=384, top_k=8, d_expert_ff=2048, n_shared=1, d_shared_ff=2048
    ),
    notes="GQA per the assignment (the released K2 uses MLA; recorded as an "
    "assignment-level substitution in DESIGN.md). Layer-0-dense detail of "
    "the release is not modeled.",
)

SMOKE = base.shrink(CONFIG)
