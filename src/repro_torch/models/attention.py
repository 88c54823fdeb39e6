"""Attention layers: GQA/MQA, sliding window; prefill and decode.

Counterpart of ``repro/models/attention.py``. Three routes, one semantics:

  * ``attention_einsum``  — the oracle; materializes the scores.
  * ``attention_chunked`` — online softmax over kv blocks (and query blocks
    past ``block_q``) in torch ops; never materializes S×S.
  * the flash kernel (``kernels/flash_attention``, ``csrc/flash_attention
    .cu``), selected by ``use_flash_kernel``. Forward only, and without a
    sliding window: ``forward`` raises for ``window > 0`` on that route
    (the reference silently attends to the whole sequence there).

Decode steps attend one token to a ``full`` KV cache by einsum. The
reference's decode einsums accumulate a bf16 cache in float32
(``preferred_element_type``); torch has no such product, so the port casts
the cache to float32 at each step (the products of bf16 values are exact
in float32, so only the summation order differs), which costs one float32
copy of the layer's cache per step. The cache is updated in place, where
the reference returns a new one. The ``ring`` cache of sliding-window
layers and cross-attention come with the rest of the model zoo (ROADMAP
queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, Params

NEG_INF = -1e30
IMPLS = ("chunked", "einsum")


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #
def init(generator: torch.Generator | None, cfg: ModelConfig, *, device) -> Params:
    d = cfg.d_model
    bias = cfg.use_qkv_bias
    return {
        "wq": common.dense_init(generator, d, cfg.q_dim, bias=bias, device=device),
        "wk": common.dense_init(generator, d, cfg.kv_dim, bias=bias, device=device),
        "wv": common.dense_init(generator, d, cfg.kv_dim, bias=bias, device=device),
        "wo": common.dense_init(generator, cfg.q_dim, d, device=device),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)  # [B,H,S,D], a strided view


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _window_mask(mask: torch.Tensor, qpos, kpos, window: int) -> torch.Tensor:
    if window > 0:
        mask = mask & (qpos - kpos < max(window, 1))
    return mask


# --------------------------------------------------------------------- #
# core attention math
# --------------------------------------------------------------------- #
def attention_einsum(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Oracle route. q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qg = q.reshape(b, hkv, group, sq, d).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) / (d**0.5)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    mask = _window_mask(mask, qpos, kpos, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
    block_k: int = 1024,
    block_q: int = 4096,
) -> torch.Tensor:
    """Online softmax over kv blocks, looped over query blocks as well
    when ``Sq`` is a multiple of ``block_q`` above it: the largest transient
    is a [B, Hq, block_q, block_k] float32 score block."""
    b, hq, sq, d = q.shape
    if sq > block_q and sq % block_q == 0:
        return torch.cat([
            attention_chunked(
                q[:, :, i:i + block_q], k, v, causal=causal, window=window,
                q_offset=q_offset + i, block_k=block_k, block_q=block_q)
            for i in range(0, sq, block_q)
        ], dim=2)
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    bk = min(block_k, skv)
    pad = (-skv) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qg = (q.reshape(b, hkv, group, sq, d) * d**-0.5).to(torch.float32)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]  # [Sq,1]

    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=dev)
    for start in range(0, k.shape[2], bk):
        kblk = k[:, :, start:start + bk].to(torch.float32)
        vblk = v[:, :, start:start + bk].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk)  # [B,Hkv,G,Sq,BK]
        kpos = start + torch.arange(bk, device=dev)[None, :]
        mask = kpos < skv  # padding
        if causal:
            mask = mask & (qpos >= kpos)
        mask = _window_mask(mask, qpos, kpos, window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


# --------------------------------------------------------------------- #
# full layers (projections + rope + attention)
# --------------------------------------------------------------------- #
def forward(
    x: torch.Tensor,
    params: Params,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    positions: torch.Tensor | None = None,
    use_rope: bool = True,
    impl: str = "chunked",
    use_flash_kernel: bool = False,
    block_k: int = 1024,
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if use_flash_kernel and window > 0:
        raise ValueError(
            f"window={window}: the flash kernel has no sliding window; use impl "
            "'chunked' or 'einsum' for sliding-window layers")
    _, s, _ = x.shape
    q = _split_heads(common.dense(x, params["wq"]), cfg.n_heads)
    k = _split_heads(common.dense(x, params["wk"]), cfg.n_kv_heads)
    v = _split_heads(common.dense(x, params["wv"]), cfg.n_kv_heads)
    if use_rope:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    if use_flash_kernel:
        out = fa_ops.flash_attention(q, k, v, causal=causal)
    elif impl == "einsum":
        out = attention_einsum(q, k, v, causal=causal, window=window)
    else:
        out = attention_chunked(q, k, v, causal=causal, window=window, block_k=block_k)
    return common.dense(_merge_heads(out), params["wo"])


# --------------------------------------------------------------------- #
# KV cache + decode step
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    kind: str      # "full" (the "ring" cache is not ported yet)
    length: int    # S_max


def init_cache(
    batch: int, cfg: ModelConfig, spec: CacheSpec, dtype=torch.bfloat16, *, device
) -> Params:
    if spec.kind != "full":
        raise NotImplementedError(
            f"cache kind {spec.kind!r}: the sliding-window ring cache comes with the rest of "
            "the model zoo (ROADMAP queue 1 item 10)")
    shape = (batch, cfg.n_kv_heads, spec.length, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(
    x: torch.Tensor,
    cache: Params,
    pos: int,
    params: Params,
    cfg: ModelConfig,
    *,
    spec: CacheSpec,
    window: int = 0,
    use_rope: bool = True,
) -> tuple[torch.Tensor, Params]:
    """One-token decode. x [B,1,d_model]; pos the index being written.
    Writes this token's k and v into ``cache`` in place and returns it."""
    b = x.shape[0]
    q = _split_heads(common.dense(x, params["wq"]), cfg.n_heads)
    k_new = _split_heads(common.dense(x, params["wk"]), cfg.n_kv_heads)
    v_new = _split_heads(common.dense(x, params["wv"]), cfg.n_kv_heads)
    if use_rope:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, posv, cfg.rope_theta)
        k_new = common.apply_rope(k_new, posv, cfg.rope_theta)

    k_cache, v_cache = cache["k"], cache["v"]
    slot = min(max(pos, 0), spec.length - 1)  # dynamic_update_slice clamps its start
    k_cache[:, :, slot] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, slot] = v_new[:, :, 0].to(v_cache.dtype)

    kpos = torch.arange(spec.length, device=x.device)[None, :]
    valid = _window_mask(kpos <= pos, pos, kpos, window)

    hkv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, hkv, group, 1, cfg.head_dim).to(k_cache.dtype)
    s = torch.einsum(
        "bhgqd,bhkd->bhgqk", qg.to(torch.float32), k_cache.to(torch.float32)
    ) / (cfg.head_dim**0.5)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum(
        "bhgqk,bhkd->bhgqd", p.to(v_cache.dtype).to(torch.float32), v_cache.to(torch.float32)
    )
    out = out.reshape(b, cfg.n_heads, 1, cfg.head_dim).to(x.dtype)
    return common.dense(_merge_heads(out), params["wo"]), cache
