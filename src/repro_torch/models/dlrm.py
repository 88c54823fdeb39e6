"""DLRM — the recommender model the paper's pipeline feeds (Naumov et al.).

Counterpart of ``repro/models/dlrm.py``. Consumes exactly what Piper
emits: log-transformed dense features and vocabulary-encoded sparse
ordinals. The bottom MLP embeds the dense features; per-column embedding
tables (the embedding-gather kernel, ``kernels/embedding_bag``) embed the
sparse ones; a pairwise-dot interaction and the top MLP give the CTR logit.

The MLP products and the Gram matrix are ``torch.matmul`` / ``einsum``,
as the JAX package leaves them to XLA outside any Pallas kernel. The
parameters keep the reference's tree and shapes (``params_tree``), so
``interop`` and the checkpoints carry them across packages.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models.common import Dense


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    vocab_range: int = 5000
    embed_dim: int = 64
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 256, 1)

    @property
    def n_pairs(self) -> int:
        f = self.n_sparse + 1  # +1 for the bottom-MLP dense vector
        return f * (f - 1) // 2


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" raises when there is no card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DLRM(device='cuda') but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


class DLRM(nn.Module):
    """The DLRM of ``cfg`` on ``device``, initialised from ``generator`` as
    the reference's ``init`` does: tables ``normal · embed_dim**-0.5``, MLP
    weights ``normal · d_in**-0.5``, zero biases, drawn in that order. The
    generator must live on ``device``. ``generator=None`` leaves the weights
    uninitialised, for a caller that loads them.
    """

    def __init__(
        self, cfg: DLRMConfig, *, device="cuda", generator: torch.Generator | None = None
    ):
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embed_dim:
            raise ValueError(
                f"bottom_mlp must end at embed_dim ({cfg.embed_dim}), got {cfg.bottom_mlp}: "
                "the dense vector joins the embeddings in the pairwise interaction"
            )
        dev = _resolve_device(device)
        self.cfg = cfg
        tables = torch.empty(
            (cfg.n_sparse, cfg.vocab_range, cfg.embed_dim), dtype=torch.float32, device=dev
        )
        if generator is not None:
            tables.normal_(generator=generator).mul_(cfg.embed_dim**-0.5)
        self.tables = nn.Parameter(tables)

        def mlp(d_in, widths):
            layers = []
            for w in widths:
                layers.append(Dense(d_in, w, device=dev, generator=generator))
                d_in = w
            return nn.ModuleList(layers)

        self.bottom = mlp(cfg.n_dense, cfg.bottom_mlp)
        self.top = mlp(cfg.n_pairs + cfg.bottom_mlp[-1], cfg.top_mlp)
        f = cfg.n_sparse + 1
        # row-major upper triangle, as jnp.triu_indices
        self.register_buffer("triu", torch.triu_indices(f, f, 1, device=dev), persistent=False)

    @staticmethod
    def _mlp(x: torch.Tensor, layers: nn.ModuleList) -> torch.Tensor:
        for i, layer in enumerate(layers):
            x = layer(x)
            if i + 1 < len(layers):
                x = torch.relu(x)
        return x

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
        """dense f32 [B, n_dense] (Piper-transformed), sparse int32
        [B, n_sparse] (vocab ordinals) → CTR logits f32 [B]."""
        bot = self._mlp(dense, self.bottom)                     # [B, E]
        emb = eb_ops.embedding_gather(self.tables, sparse)      # [B, C, E]
        feats = torch.cat([bot[:, None], emb], dim=1)           # [B, F, E]
        gram = torch.einsum("bfe,bge->bfg", feats, feats)       # [B, F, F]
        pairs = gram[:, self.triu[0], self.triu[1]]             # [B, F(F-1)/2]
        top_in = torch.cat([bot, pairs], dim=1)
        return self._mlp(top_in, self.top)[:, 0]

    def params_tree(self) -> dict:
        """The parameters in the reference's tree: ``{"tables", "bottom":
        [{"w", "b"}, ...], "top": [...]}``, the ``nn.Parameter`` objects
        themselves."""

        def layers(mods):
            return [{"w": m.w, "b": m.b} for m in mods]

        return {"tables": self.tables, "bottom": layers(self.bottom), "top": layers(self.top)}


def loss(model: DLRM, batch: dict) -> torch.Tensor:
    """Binary cross-entropy on the click label, in the reference's own
    formula: ``mean(max(l, 0) - l·y + log1p(exp(-|l|)))``."""
    logits = model(batch["dense"], batch["sparse"])
    y = batch["label"].to(torch.float32)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    )
