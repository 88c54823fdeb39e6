"""Decoder-only language model: superblocks of attention + MLP layers.

Counterpart of ``repro/models/lm.py::LM`` for ``kind="attn"`` layers with
causal or bidirectional attention and dense MLPs. Other layer kinds (MoE,
SSM, hybrid, cross-attention) and ``EncDec`` come with the rest of the
model zoo, and LM training (``loss``, ``chunked_ce``) with ROADMAP queue 1
item 12; both raise ``NotImplementedError`` until then.

The parameters are the reference's tree, with the stacked per-spec arrays
unstacked into a list: ``{"embed" [V, d], "blocks": [superblock][spec]
dicts, "final_norm", "lm_head" (untied only)}``, float32 at rest, cast to
the compute dtype at each use. The reference runs the superblocks as one
``lax.scan``; here they are a Python loop, with the same float32 residual
carry across superblocks.

Entry points:
    init(generator)                          → params
    hidden(params, tokens)                   → final-norm hidden states
    forward(params, tokens)                  → logits
    init_decode_state(batch, cache_len)      → per-layer KV caches
    decode_step(params, token, state, pos)   → (logits, state)

``attn_impl`` picks the attention route of the full-sequence passes:
``"chunked"`` (the reference's default), ``"einsum"``, or ``"flash"``, the
hand-written kernel (``attention.forward(use_flash_kernel=True)``), which
is forward only: a backward through it raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention, common, mlp
from repro_torch.models.common import LayerSpec, ModelConfig, Params

ATTN_IMPLS = ("chunked", "einsum", "flash")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.attn not in ("causal", "bidir") or spec.moe:
        raise NotImplementedError(
            f"layer {spec}: the port has dense attention layers (causal or bidir) with dense "
            "MLPs; MoE, SSM, hybrid and cross-attention layers come with the rest of the model "
            "zoo (ROADMAP queue 1 item 10)")


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" raises when there is no card.
    "meta" builds parameters without memory (``ModelConfig.param_count``)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "LM(device='cuda') but no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


# --------------------------------------------------------------------- #
# per-spec block: params / forward / cache / decode
# --------------------------------------------------------------------- #
def _block_init(generator, spec: LayerSpec, cfg: ModelConfig, *, device) -> Params:
    _check_spec(spec)
    p: Params = {"ln1": common.norm_init(cfg.d_model, cfg.norm, device=device),
                 "attn": attention.init(generator, cfg, device=device)}
    if spec.mlp:
        p["ln2"] = common.norm_init(cfg.d_model, cfg.norm, device=device)
        p["mlp"] = mlp.init(generator, cfg, spec.mlp, device=device)
    return p


def _block_forward(
    x: torch.Tensor, p: Params, spec: LayerSpec, cfg: ModelConfig, *, impl: str,
    block_k: int = 1024,
) -> torch.Tensor:
    """Full-sequence block."""
    _check_spec(spec)
    h = common.norm(x, p["ln1"], cfg.norm)
    flash = impl == "flash"
    x = x + attention.forward(
        h, p["attn"], cfg, causal=spec.attn == "causal", window=spec.window,
        impl="chunked" if flash else impl, use_flash_kernel=flash, block_k=block_k)
    if spec.mlp:
        x = x + mlp.forward(common.norm(x, p["ln2"], cfg.norm), p["mlp"], spec.mlp)
    return x


def _block_cache_init(
    batch: int, spec: LayerSpec, cfg: ModelConfig, cache_len: int, dtype, *, device
) -> Params:
    """Decode-state skeleton for one spec (zeros; decode fills it)."""
    _check_spec(spec)
    kind = "ring" if spec.window else "full"
    length = min(spec.window, cache_len) if spec.window else cache_len
    return {"kv": attention.init_cache(
        batch, cfg, attention.CacheSpec(kind, length), dtype, device=device)}


def _cache_spec_of(cache: Params) -> attention.CacheSpec:
    return attention.CacheSpec("full", cache["kv"]["k"].shape[2])


def _block_decode(
    x: torch.Tensor, cache: Params, p: Params, spec: LayerSpec, cfg: ModelConfig, pos: int
) -> tuple[torch.Tensor, Params]:
    _check_spec(spec)
    new_cache = dict(cache)
    h = common.norm(x, p["ln1"], cfg.norm)
    y, new_cache["kv"] = attention.decode_step(
        h, cache["kv"], pos, p["attn"], cfg, spec=_cache_spec_of(cache),
        window=spec.window)
    x = x + y
    if spec.mlp:
        x = x + mlp.forward(common.norm(x, p["ln2"], cfg.norm), p["mlp"], spec.mlp)
    return x, new_cache


# --------------------------------------------------------------------- #
# loss helper
# --------------------------------------------------------------------- #
def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [B,S,V] (any dtype); targets int [B,S] → mean NLL (float32),
    in the reference's logsumexp form."""
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp((logits - m).to(torch.float32)), dim=-1)) \
        + m[..., 0].to(torch.float32)
    lab = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - lab.to(torch.float32))


# --------------------------------------------------------------------- #
# the LM
# --------------------------------------------------------------------- #
@dataclasses.dataclass(eq=False)
class LM:
    cfg: ModelConfig
    attn_impl: str = "chunked"  # "chunked" | "einsum" | "flash"
    attn_block_k: int = 1024    # kv block of the chunked online softmax
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        for spec in self.cfg.superblock:
            _check_spec(spec)
        self.device = _resolve_device(self.device)

    # ------------------------- params ------------------------------- #
    def init(self, generator: torch.Generator | None = None) -> Params:
        """Parameters on the model's device, drawn from ``generator`` (which
        must live there): the embedding ``normal · 0.02``, then every layer
        in order, then the untied head; projections ``normal · d_in**-0.5``,
        norms ones. ``generator=None`` leaves them uninitialised, for a
        caller that loads them (``interop.lm_params_from_numpy``)."""
        cfg, dev = self.cfg, self.device
        params: Params = {
            "embed": common.normal((cfg.vocab_size, cfg.d_model), 0.02,
                                   generator=generator, device=dev),
            "blocks": [
                [_block_init(generator, spec, cfg, device=dev) for spec in cfg.superblock]
                for _ in range(cfg.n_superblocks)
            ],
            "final_norm": common.norm_init(cfg.d_model, cfg.norm, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = common.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                                  device=dev)
        return params

    # ------------------------- forward ------------------------------ #
    def _superblock_body(self, x32: torch.Tensor, sb_params, compute_dtype) -> torch.Tensor:
        """One superblock with a float32 residual carry: the stream rounds
        to the compute dtype at each superblock's entry, and the block's
        delta (exact in float32) is added to the float32 carry."""
        xb = x32.to(compute_dtype)
        xo = xb
        for spec, p in zip(self.cfg.superblock, sb_params):
            xo = _block_forward(xo, p, spec, self.cfg, impl=self.attn_impl,
                                block_k=self.attn_block_k)
        if compute_dtype == torch.float32:
            return xo
        return x32 + (xo.to(torch.float32) - xb.to(torch.float32))

    def hidden(self, params: Params, tokens: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
        """Trunk only: tokens int [B,S] → final-norm hidden [B,S,d]. (The
        reference also returns the MoE auxiliary loss, always 0 here.)"""
        x32 = params["embed"][tokens.to(torch.int64)].to(compute_dtype).to(torch.float32)
        for sb in params["blocks"]:
            x32 = self._superblock_body(x32, sb, compute_dtype)
        return common.norm(x32.to(compute_dtype), params["final_norm"], self.cfg.norm)

    def head_weight(self, params: Params) -> torch.Tensor:
        """[d, V] output-projection weight (tied or dedicated)."""
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]["w"]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        logits = x @ self.head_weight(params).to(x.dtype)
        if not self.cfg.tie_embeddings and "b" in params["lm_head"]:
            logits = logits + params["lm_head"]["b"].to(x.dtype)
        return logits

    def forward(self, params: Params, tokens: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
        """tokens int [B,S] → logits [B,S,V] in the compute dtype."""
        return self._head(params, self.hidden(params, tokens, compute_dtype))

    # ------------------------- serving ------------------------------ #
    def init_decode_state(self, batch: int, cache_len: int, dtype=torch.bfloat16) -> list:
        """[superblock][spec] caches, zeros."""
        return [
            [_block_cache_init(batch, spec, self.cfg, cache_len, dtype, device=self.device)
             for spec in self.cfg.superblock]
            for _ in range(self.cfg.n_superblocks)
        ]

    def decode_step(self, params: Params, token: torch.Tensor, state: list, pos: int,
                    compute_dtype=torch.bfloat16) -> tuple[torch.Tensor, list]:
        """token int [B] at index ``pos`` → (logits [B, V], state). The
        stream stays in the compute dtype across layers, as in the
        reference's decode; the caches are updated in place."""
        cfg = self.cfg
        x = params["embed"][token.to(torch.int64)][:, None].to(compute_dtype)
        new_state = []
        for sb_params, sb_cache in zip(params["blocks"], state):
            new_caches = []
            for spec, p, c in zip(cfg.superblock, sb_params, sb_cache):
                x, nc = _block_decode(x, c, p, spec, cfg, pos)
                new_caches.append(nc)
            new_state.append(new_caches)
        x = common.norm(x, params["final_norm"], cfg.norm)
        return self._head(params, x)[:, 0], new_state
