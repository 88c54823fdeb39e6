"""whisper-small [audio]: 12L enc + 12L dec, d=768, 12H (kv=12), ff=3072,
vocab=51865. Enc-dec with (stub) conv frontend — the encoder consumes
precomputed frame embeddings per the assignment brief.
[arXiv:2212.04356]

Counterpart of ``repro/configs/whisper_small.py``.
"""

from repro_torch.configs import base
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    # decoder block: causal self-attn → cross-attn to encoder → MLP
    superblock=(
        LayerSpec(kind="attn", attn="causal", mlp=""),
        LayerSpec(kind="attn", attn="cross", mlp="gelu"),
    ),
    n_superblocks=12,
    encoder_superblock=(LayerSpec(kind="attn", attn="bidir", mlp="gelu"),),
    n_encoder_superblocks=12,
    encoder_frames=1500,
    norm="layernorm",
    notes=(
        "Conv frontend stubbed (precomputed frame embeddings). RoPE used in "
        "place of learned absolute positions (deviation noted in DESIGN.md). "
        "The paper's 12L counts each of encoder/decoder."
    ),
)

SMOKE = base.shrink(CONFIG)
