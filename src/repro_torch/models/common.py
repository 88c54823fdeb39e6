"""Shared model machinery: configs, norms, RoPE, projections, init.

Counterpart of ``repro/models/common.py``. The DLRM uses :class:`Dense`
(``dense_init`` / ``dense`` as a module). The language models use the rest
as the reference does: parameters are plain dicts of float32 tensors,
cast to the compute dtype at each use, and the layers are functions over
them. The configs are the reference's plain dataclasses; ``MoEConfig``
and ``SSMConfig`` come along because ``configs/base.shrink`` builds them,
though no MoE or SSM layer is ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

Params = Any  # nested dict of tensors


# --------------------------------------------------------------------- #
# Layer / model configs
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"      # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_inner: int = 0         # 0 → d_model
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a superblock."""

    kind: str = "attn"        # "attn" | "mamba" | "mlstm" | "slstm" | "hymba"
    attn: str = "causal"      # "causal" | "bidir" | "cross"
    window: int = 0           # >0 → sliding-window attention
    mlp: str = "swiglu"       # "swiglu" | "geglu" | "gelu" | "relu2" | "" (none)
    moe: bool = False         # route the MLP through the MoE layer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | enc_dec | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    superblock: tuple[LayerSpec, ...]
    n_superblocks: int
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    n_encoder_superblocks: int = 0
    encoder_superblock: tuple[LayerSpec, ...] = ()
    encoder_frames: int = 1500
    vision_tokens: int = 0
    use_qkv_bias: bool = False
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sub_quadratic: bool = False
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.superblock) * self.n_superblocks

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Exact parameter count, from the port's own parameters built on
        the ``meta`` device (no memory)."""
        from repro_torch.models import lm as _lm
        from repro_torch.train.tree import leaves

        params = _lm.LM(self, device="meta").init()
        return sum(t.numel() for t in leaves(params))


# --------------------------------------------------------------------- #
# Primitive layers (functions over param dicts)
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def norm(x: torch.Tensor, params: Params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def norm_init(d: int, kind: str, *, device) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def normal(shape, scale: float, *, generator: torch.Generator | None, device) -> torch.Tensor:
    """float32 ``normal · scale`` of ``shape`` drawn from ``generator``;
    left uninitialised with ``generator=None``, for a caller that loads it."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not None:
        t.normal_(generator=generator).mul_(scale)
    return t


def dense_init(
    generator: torch.Generator | None, d_in: int, d_out: int, bias: bool = False,
    scale: float | None = None, *, device,
) -> Params:
    scale = scale if scale is not None else d_in**-0.5
    p = {"w": normal((d_in, d_out), scale, generator=generator, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``x @ w (+ b)``, the float32 weight cast to x's dtype at this use."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# --------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, D]; positions int [..., S] (broadcastable). Rotates the two
    halves of the last dimension (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu" or kind == "geglu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    return torch.nn.functional.silu(x)  # swiglu / default


class Dense(nn.Module):
    """``y = x @ w + b`` in the JAX package's layout: ``w [d_in, d_out]``,
    ``b [d_out]`` (not ``nn.Linear``'s ``[out, in]``), so weights carry
    across packages without a transpose.

    ``w`` is drawn from ``generator`` as ``normal · d_in**-0.5`` and ``b``
    is zero, as ``dense_init(..., bias=True)`` does. With
    ``generator=None`` the weights are left uninitialised, for a caller
    that loads them (``interop.dlrm_params_from_numpy``, a checkpoint).
    """

    def __init__(
        self, d_in: int, d_out: int, *, device="cuda", generator: torch.Generator | None = None
    ):
        super().__init__()
        self.w = nn.Parameter(normal((d_in, d_out), d_in**-0.5, generator=generator,
                                     device=device))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b
