"""Config helpers shared by the per-architecture files.

Counterpart of ``repro/configs/base.py``. Every arch module exports
``CONFIG`` (the exact published configuration) and ``SMOKE`` (a reduced
same-family config for CPU tests: small width, depth and vocab, structure
preserved).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig, SSMConfig


def dense_lm(
    name: str,
    *,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    vocab_size: int,
    head_dim: int | None = None,
    mlp: str = "swiglu",
    **kw,
) -> ModelConfig:
    return ModelConfig(
        name=name,
        family=kw.pop("family", "dense"),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=head_dim if head_dim is not None else d_model // n_heads,
        d_ff=d_ff,
        vocab_size=vocab_size,
        superblock=(LayerSpec(kind="attn", attn="causal", mlp=mlp),),
        n_superblocks=n_layers,
        **kw,
    )


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family smoke config (structure preserved)."""
    defaults = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        n_superblocks=min(cfg.n_superblocks, 2),
        vision_tokens=16 if cfg.vision_tokens else 0,
        encoder_frames=32 if cfg.n_encoder_superblocks else cfg.encoder_frames,
        n_encoder_superblocks=min(cfg.n_encoder_superblocks, 2),
    )
    if cfg.moe is not None:
        defaults["moe"] = MoEConfig(
            n_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_expert_ff=32,
            n_shared=min(cfg.moe.n_shared, 1),
            d_shared_ff=32 if cfg.moe.n_shared else 0,
            capacity_factor=8.0,  # no capacity drops in smoke configs
        )
    if cfg.ssm is not None:
        defaults["ssm"] = SSMConfig(kind=cfg.ssm.kind, d_state=8, d_inner=64, chunk=16)
    # shrink window sizes and keep the first occurrence of each distinct
    # spec (at most 4)
    sb = tuple(
        dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
        for s in cfg.superblock
    )
    seen, kept = set(), []
    for s in sb:
        key = (s.kind, s.attn, s.window > 0, s.mlp, s.moe)
        if key not in seen:
            seen.add(key)
            kept.append(s)
    defaults["superblock"] = tuple(kept[:4]) or sb[:1]
    if cfg.encoder_superblock:
        defaults["encoder_superblock"] = cfg.encoder_superblock
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
