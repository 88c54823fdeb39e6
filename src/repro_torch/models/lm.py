"""Language models: superblocks of attention, SSM and MLP layers.

Counterpart of ``repro/models/lm.py``: :class:`LM` for every layer kind,
``attn`` (causal or bidirectional, optionally sliding-window, or
``cross``: attention to a context of patch or encoder states), ``hymba``
(attention and Mamba heads in parallel on the same input,
``x + 0.5·(rms(a) + rms(m))``), ``mamba``, ``mlstm`` and ``slstm``, each
with a dense or an MoE MLP (``LayerSpec.moe``); and :class:`EncDec`, the
whisper-style encoder-decoder, whose decoder is an ``LM`` with cross
layers over the encoder's output.

The parameters are the reference's tree, with the stacked per-spec arrays
unstacked into a list: ``{"embed" [V, d], "blocks": [superblock][spec]
dicts, "final_norm", "lm_head" (untied only)}``, float32 at rest, cast to
the compute dtype at each use. The reference runs the superblocks as one
``lax.scan``; here they are a Python loop, with the same float32 residual
carry across superblocks and the MoE auxiliary loss summed over layers.

Entry points (``context`` [B, Sc, d]: the vision LM's patch embeddings,
or the encoder's output; only cross layers read it):
    init(generator)                              → params
    trunk(params, tokens, context=)              → (final-norm hidden, MoE aux)
    hidden(params, tokens, context=)             → final-norm hidden states
    forward(params, tokens, context=)            → logits
    loss(params, tokens, context=)               → next-token CE + aux_weight · aux
    init_decode_state(batch, cache_len)          → per-layer caches and states
    fill_context_caches(params, state, context)  → state with the cross layers' k/v
    decode_step(params, token, state, pos)       → (logits, state)

A layer's decode state is the reference's: ``{"kv": {"k", "v"}}`` (a
``ring`` cache of ``min(window, cache_len)`` slots with ``slot_pos`` for a
sliding-window layer), ``"ctx_kv": {"k", "v"}`` for a cross layer
(``[B, Hkv, vision_tokens or encoder_frames, D]``, zeros until
``fill_context_caches``), ``"mamba"`` [B, di, N], ``"mlstm": {"s", "n"}``,
``"slstm": {"c", "n", "h", "m"}``, the recurrent states float32.

Training: ``loss`` differentiates once the parameters require gradients
(``train/steps.py::trainable``; ``init`` makes plain tensors, which
prefill and serving use under ``torch.no_grad``). With ``remat`` (the
default) each superblock runs under a non-reentrant
``torch.utils.checkpoint``, so the backward keeps only the float32 carry
between superblocks and recomputes the rest, as the reference's
``jax.checkpoint`` does; ``chunked_ce`` checkpoints each sequence block,
so the full [B, S, V] logits are never held.

``attn_impl`` picks the attention route of the full-sequence passes:
``"chunked"`` (the reference's default, and the one that trains),
``"einsum"``, or ``"flash"``, the hand-written kernel
(``attention.forward`` / ``cross_forward`` with ``use_flash_kernel=True``),
which is forward only: a backward through it raises. On the flash route a
layer takes the kernel where its contract takes the layer's shapes
(``flash_attention.ops.takes``: no sliding window, each sequence length a
multiple of ``min(128, length)``, causal layers ``Sq == Skv``), and the
chunked route otherwise, chosen from the shapes. The reference's flash
path attends to the whole sequence in windowed layers (a fault of the
reference, ROADMAP queue 3), which the port does not copy. Cross layers
run the chunked route on the ``"einsum"`` route too, as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shard_lib
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention, common, mlp, ssm
from repro_torch.models.common import LayerSpec, ModelConfig, Params

ATTN_IMPLS = ("chunked", "einsum", "flash")
KINDS = ("attn", "hymba", "mamba", "mlstm", "slstm")
ATTN_KINDS = ("causal", "bidir", "cross")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in KINDS:
        raise ValueError(f"layer {spec}: kind must be one of {KINDS}")
    if spec.kind == "attn" and spec.attn not in ATTN_KINDS:
        raise ValueError(f"layer {spec}: attn must be one of {ATTN_KINDS}")


def _is_cross(spec: LayerSpec) -> bool:
    return spec.kind == "attn" and spec.attn == "cross"


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
    p: Params = {"ln1": common.norm_init(cfg.d_model, cfg.norm, device=device)}
    if spec.kind in ("attn", "hymba"):
        p["attn"] = attention.init(generator, cfg, device=device)
    if spec.kind in ("hymba", "mamba"):
        p["mamba"] = ssm.mamba_init(generator, cfg, device=device)
    if spec.kind == "hymba":
        p["ln_a"] = common.norm_init(cfg.d_model, "rmsnorm", device=device)
        p["ln_m"] = common.norm_init(cfg.d_model, "rmsnorm", device=device)
    if spec.kind == "mlstm":
        p["mlstm"] = ssm.mlstm_init(generator, cfg, device=device)
    if spec.kind == "slstm":
        p["slstm"] = ssm.slstm_init(generator, cfg, device=device)
    if spec.mlp:
        p["ln2"] = common.norm_init(cfg.d_model, cfg.norm, device=device)
        p["mlp"] = (mlp.moe_init(generator, cfg, spec.mlp, device=device) if spec.moe
                    else mlp.init(generator, cfg, spec.mlp, device=device))
    return p


def _hymba_mix(x, a, m, p):
    """hymba's update: the attention and Mamba heads, each rms-normalised."""
    return x + 0.5 * (common.norm(a, p["ln_a"], "rmsnorm") + common.norm(m, p["ln_m"], "rmsnorm"))


def _block_mlp(x: torch.Tensor, p: Params, spec: LayerSpec, cfg: ModelConfig):
    """The block's MLP half → (x, the MoE auxiliary loss; the Python float
    0.0 for a dense MLP or none, so that dense layers launch nothing for
    it)."""
    aux = 0.0
    if spec.mlp:
        h2 = common.norm(x, p["ln2"], cfg.norm)
        if spec.moe:
            y, aux = mlp.moe_forward(h2, p["mlp"], cfg, spec.mlp)
        else:
            y = mlp.forward(h2, p["mlp"], spec.mlp)
        x = x + y
    return x, aux


def _block_forward(
    x: torch.Tensor, p: Params, spec: LayerSpec, cfg: ModelConfig, *, impl: str,
    block_k: int = 1024, context: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, MoE aux: a float32 tensor for an MoE
    layer, else 0.0). A cross layer attends to ``context`` [B, Sc, d]
    through its own ``wk``/``wv``."""
    _check_spec(spec)
    h = common.norm(x, p["ln1"], cfg.norm)
    s = x.shape[1]
    if _is_cross(spec):
        if context is None:
            raise ValueError(f"layer {spec}: a cross-attention layer needs a context")
        kv = attention.context_kv(context, p["attn"], cfg)
        flash = impl == "flash" and fa_ops.takes(s, kv[0].shape[2], causal=False)
        x = x + attention.cross_forward(h, kv, p["attn"], cfg, use_flash_kernel=flash)
    elif spec.kind in ("attn", "hymba"):
        causal = spec.kind == "hymba" or spec.attn == "causal"
        flash = impl == "flash" and spec.window == 0 and fa_ops.takes(s, s, causal=causal)
        a = attention.forward(
            h, p["attn"], cfg, causal=causal, window=spec.window,
            impl="chunked" if impl == "flash" else impl, use_flash_kernel=flash,
            block_k=block_k)
        if spec.kind == "attn":
            x = x + a
        else:
            m, _ = ssm.mamba_forward(h, p["mamba"], cfg)
            x = _hymba_mix(x, a, m, p)
    else:
        fwd = {"mamba": ssm.mamba_forward, "mlstm": ssm.mlstm_forward,
               "slstm": ssm.slstm_forward}[spec.kind]
        y, _ = fwd(h, p[spec.kind], cfg)
        x = x + y
    return _block_mlp(x, p, spec, cfg)


def _block_cache_init(
    batch: int, spec: LayerSpec, cfg: ModelConfig, cache_len: int, dtype, *, device
) -> Params:
    """Decode-state skeleton for one spec (zeros; decode fills it)."""
    _check_spec(spec)
    c: Params = {}
    if _is_cross(spec):
        shape = (batch, cfg.n_kv_heads, cfg.vision_tokens or cfg.encoder_frames, cfg.head_dim)
        c["ctx_kv"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}
    elif spec.kind in ("attn", "hymba"):
        kind = "ring" if spec.window else "full"
        length = min(spec.window, cache_len) if spec.window else cache_len
        c["kv"] = attention.init_cache(
            batch, cfg, attention.CacheSpec(kind, length), dtype, device=device)
    if spec.kind in ("hymba", "mamba"):
        c["mamba"] = ssm.mamba_init_state(batch, cfg, device=device)
    if spec.kind == "mlstm":
        s, n = ssm.mlstm_init_state(batch, cfg, device=device)
        c["mlstm"] = {"s": s, "n": n}
    if spec.kind == "slstm":
        cc, nn, hh, mm = ssm.slstm_init_state(batch, cfg, device=device)
        c["slstm"] = {"c": cc, "n": nn, "h": hh, "m": mm}
    return c


def _cache_spec_of(cache: Params) -> attention.CacheSpec:
    kv = cache["kv"]
    return attention.CacheSpec("ring" if "slot_pos" in kv else "full", kv["k"].shape[2])


def _block_decode(
    x: torch.Tensor, cache: Params, p: Params, spec: LayerSpec, cfg: ModelConfig, pos: int
) -> tuple[torch.Tensor, Params]:
    _check_spec(spec)
    new_cache = dict(cache)
    h = common.norm(x, p["ln1"], cfg.norm)
    if _is_cross(spec):
        ctx = cache["ctx_kv"]
        x = x + attention.cross_forward(h, (ctx["k"], ctx["v"]), p["attn"], cfg)
    elif spec.kind in ("attn", "hymba"):
        a, new_cache["kv"] = attention.decode_step(
            h, cache["kv"], pos, p["attn"], cfg, spec=_cache_spec_of(cache),
            window=spec.window)
        if spec.kind == "attn":
            x = x + a
        else:
            m, new_cache["mamba"] = ssm.mamba_decode(h, cache["mamba"], p["mamba"], cfg)
            x = _hymba_mix(x, a, m, p)
    elif spec.kind == "mamba":
        y, new_cache["mamba"] = ssm.mamba_decode(h, cache["mamba"], p["mamba"], cfg)
        x = x + y
    elif spec.kind == "mlstm":
        st = cache["mlstm"]
        y, (s, n) = ssm.mlstm_decode(h, (st["s"], st["n"]), p["mlstm"], cfg)
        new_cache["mlstm"] = {"s": s, "n": n}
        x = x + y
    else:
        st = cache["slstm"]
        y, (cc, nn, hh, mm) = ssm.slstm_decode(h, (st["c"], st["n"], st["h"], st["m"]),
                                               p["slstm"], cfg)
        new_cache["slstm"] = {"c": cc, "n": nn, "h": hh, "m": mm}
        x = x + y
    x, _ = _block_mlp(x, p, spec, cfg)
    return x, new_cache


def _recurrent_states(cache: Params):
    """A layer's recurrent state tensors, each with its initial value
    (``ssm.*_init_state``)."""
    if "mamba" in cache:
        yield cache["mamba"], 0.0
    for t in cache.get("mlstm", {}).values():
        yield t, 0.0
    for name, t in cache.get("slstm", {}).items():
        yield t, ssm.SLSTM_M_INIT if name == "m" else 0.0


def reset_decode_rows(state: list, rows) -> None:
    """Start batch rows ``rows`` of a decode state (``LM.init_decode_state``)
    anew, in place, for a new request: every recurrent state's rows back
    to their initial value. The KV caches keep their rows: the decode's
    position mask (``kpos <= pos``, a ring's ``slot_pos``) hides what an
    earlier request wrote until the new one has overwritten it. A cross
    layer's ``ctx_kv`` is not a recurrent state and is left alone: it holds
    what ``LM.fill_context_caches`` last wrote."""
    for sb in state:
        for cache in sb:
            for t, init in _recurrent_states(cache):
                for i in rows:
                    t[i].fill_(init)


# --------------------------------------------------------------------- #
# loss helpers
# --------------------------------------------------------------------- #
def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [B,S,V] (any dtype); targets int [B,S] → mean NLL (float32),
    in the reference's logsumexp form. Small shapes only; training uses
    :func:`chunked_ce`."""
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp((logits - m).to(torch.float32)), dim=-1)) \
        + m[..., 0].to(torch.float32)
    lab = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - lab.to(torch.float32))


def _ce_block(xblk: torch.Tensor, w: torch.Tensor, tblk: torch.Tensor,
              wblk: torch.Tensor) -> torch.Tensor:
    """One sequence block of :func:`chunked_ce`: its logits [B, blk, V] in
    x's dtype, reduced to the weighted NLL sum in float32."""
    logits = xblk @ w.to(xblk.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp((logits - m).to(torch.float32)), dim=-1)) \
        + m[..., 0].to(torch.float32)
    lab = torch.gather(logits, -1, tblk[..., None].to(torch.int64))[..., 0]
    return torch.sum((lse - lab.to(torch.float32)) * wblk)


def chunked_ce(
    x: torch.Tensor,        # [B, S, d] final hidden states
    w: torch.Tensor,        # [d, V] head weights (cast at use)
    targets: torch.Tensor,  # int [B, S]
    weights: torch.Tensor,  # float32 [B, S] (0 masks a position)
    block: int = 512,
) -> torch.Tensor:
    """Head projection + softmax CE over sequence blocks of ``block``
    (the sequence padded to a multiple of it with weight 0), the weighted
    mean NLL in float32. While autograd records, each block runs under a
    non-reentrant checkpoint, so the backward recomputes its [B, block, V]
    logits and never holds [B, S, V]."""
    b, s, _ = x.shape
    pad = (-s) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s + pad, block):
        blk = (x[:, start:start + block], w, targets[:, start:start + block],
               weights[:, start:start + block])
        total = total + (checkpoint(_ce_block, *blk, use_reentrant=False,
                                    preserve_rng_state=False) if remat else _ce_block(*blk))
    return total / torch.clamp(torch.sum(weights), min=1.0)


def _next_token_ce(x: torch.Tensor, w: torch.Tensor, tokens: torch.Tensor,
                   block: int) -> torch.Tensor:
    """:func:`chunked_ce` of the final hidden states ``x`` against the
    tokens shifted left, the last position weighing 0."""
    weights = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    weights[:, -1] = 0.0
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    return chunked_ce(x, w, targets, weights, block=block)


# --------------------------------------------------------------------- #
# the LM
# --------------------------------------------------------------------- #
@dataclasses.dataclass(eq=False)
class LM:
    cfg: ModelConfig
    remat: bool = True          # checkpoint each superblock while autograd records
    attn_impl: str = "chunked"  # "chunked" | "einsum" | "flash"
    attn_block_k: int = 1024    # kv block of the chunked online softmax
    ce_block: int = 512         # sequence block of the chunked-CE head
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
    def _superblock_body(self, x32: torch.Tensor, aux, sb_params, compute_dtype,
                         context=None) -> tuple[torch.Tensor, torch.Tensor | float]:
        """One superblock with a float32 residual carry: the stream rounds
        to the compute dtype at each superblock's entry, and the block's
        delta (exact in float32) is added to the float32 carry. ``aux``
        gains each MoE layer's auxiliary loss."""
        xb = x32.to(compute_dtype)
        xo = xb
        for spec, p in zip(self.cfg.superblock, sb_params):
            xo, a = _block_forward(xo, p, spec, self.cfg, impl=self.attn_impl,
                                   block_k=self.attn_block_k, context=context)
            if spec.moe:
                aux = aux + a
        if compute_dtype == torch.float32:
            return xo, aux
        return x32 + (xo.to(torch.float32) - xb.to(torch.float32)), aux

    def trunk(self, params: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
              context: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | float]:
        """tokens int [B,S] → (final-norm hidden [B,S,d], the MoE auxiliary
        loss summed over layers, float32; the Python float 0.0 without MoE
        layers), as the reference's ``hidden``. Cross layers attend to
        ``context`` [B, Sc, d], as it is given (not cast)."""
        x32 = params["embed"][tokens.to(torch.int64)].to(compute_dtype).to(torch.float32)
        aux = 0.0
        remat = self.remat and torch.is_grad_enabled()
        for sb in params["blocks"]:
            if remat:
                x32, aux = checkpoint(self._superblock_body, x32, aux, sb, compute_dtype,
                                      context, use_reentrant=False, preserve_rng_state=False,
                                      context_fn=shard_lib.checkpoint_contexts)
            else:
                x32, aux = self._superblock_body(x32, aux, sb, compute_dtype, context)
        return common.norm(x32.to(compute_dtype), params["final_norm"], self.cfg.norm), aux

    def hidden(self, params: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
               context: torch.Tensor | None = None) -> torch.Tensor:
        """Trunk only: tokens int [B,S] → final-norm hidden [B,S,d], the
        auxiliary loss dropped (prefill and serving)."""
        return self.trunk(params, tokens, compute_dtype, context)[0]

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

    def forward(self, params: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """tokens int [B,S] → logits [B,S,V] in the compute dtype."""
        return self._head(params, self.hidden(params, tokens, compute_dtype, context))

    def loss(self, params: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
             aux_weight: float = 0.01, context: torch.Tensor | None = None) -> torch.Tensor:
        """Next-token CE through :func:`chunked_ce` (the full logits are
        never held), plus ``aux_weight`` times the MoE auxiliary loss (0
        without MoE layers): the targets are the tokens shifted left, the
        last position weighs 0."""
        x, aux = self.trunk(params, tokens, compute_dtype, context)
        nll = _next_token_ce(x, self.head_weight(params), tokens, self.ce_block)
        return nll + aux_weight * aux if torch.is_tensor(aux) else nll

    # ------------------------- serving ------------------------------ #
    def init_decode_state(self, batch: int, cache_len: int, dtype=torch.bfloat16) -> list:
        """[superblock][spec] caches and recurrent states: KV caches in
        ``dtype``, zeros (ring slots -1), SSM states float32."""
        return [
            [_block_cache_init(batch, spec, self.cfg, cache_len, dtype, device=self.device)
             for spec in self.cfg.superblock]
            for _ in range(self.cfg.n_superblocks)
        ]

    @torch.no_grad()
    def fill_context_caches(self, params: Params, state: list,
                            context: torch.Tensor) -> list:
        """Write every cross layer's k and v of ``context`` [B, Sc, d] into
        its ``ctx_kv`` cache in place, cast to the cache's dtype: the
        once-a-request half of prefill. ``Sc`` must be the cache's length
        (``vision_tokens`` or ``encoder_frames``). Returns ``state``."""
        for sb_params, sb_cache in zip(params["blocks"], state):
            for spec, p, c in zip(self.cfg.superblock, sb_params, sb_cache):
                if not _is_cross(spec):
                    continue
                k, v = attention.context_kv(context, p["attn"], self.cfg)
                if k.shape != c["ctx_kv"]["k"].shape:
                    raise ValueError(
                        f"context of {tuple(context.shape)} gives k of {tuple(k.shape)}; the "
                        f"decode state's ctx_kv is {tuple(c['ctx_kv']['k'].shape)}")
                c["ctx_kv"]["k"].copy_(k)
                c["ctx_kv"]["v"].copy_(v)
        return state

    def decode_step(self, params: Params, token: torch.Tensor, state: list, pos: int,
                    compute_dtype=torch.bfloat16) -> tuple[torch.Tensor, list]:
        """token int [B] at index ``pos`` → (logits [B, V], state). The
        stream stays in the compute dtype across layers, as in the
        reference's decode; the KV caches are updated in place, the
        recurrent states replaced. MoE layers route the B tokens alone and
        drop their auxiliary loss."""
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


# --------------------------------------------------------------------- #
# the encoder-decoder (whisper)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(eq=False)
class EncDec:
    """Whisper-style encoder-decoder. The encoder reads the (stub) frame
    embeddings [B, frames, d_model], as the reference's (the conv frontend
    is out of its scope); ``self.decoder`` is an :class:`LM` whose cross
    layers attend to the encoder's output.

    Its parameters are the decoder's plus ``"encoder": {"blocks"
    [n_encoder_superblocks][spec], "pos_embed" [encoder_frames, d],
    "final_norm"}``. The encoder carries its stream in the compute dtype
    (no float32 carry) and runs each superblock under a checkpoint with
    ``remat`` while autograd records, as the reference's. Serving decodes
    through ``self.decoder`` (``train/steps.py::make_serve_step``) after
    ``decoder.fill_context_caches`` with the encoder's output."""

    cfg: ModelConfig
    remat: bool = True
    attn_impl: str = "chunked"
    attn_block_k: int = 1024
    ce_block: int = 512
    device: torch.device | str = "cuda"

    def __post_init__(self):
        for spec in self.cfg.encoder_superblock:
            _check_spec(spec)
            if _is_cross(spec):
                raise ValueError(f"encoder layer {spec}: the encoder has no context")
        self.decoder = LM(self.cfg, remat=self.remat, attn_impl=self.attn_impl,
                          attn_block_k=self.attn_block_k, ce_block=self.ce_block,
                          device=self.device)
        self.device = self.decoder.device

    def init(self, generator: torch.Generator | None = None) -> Params:
        """The decoder's parameters (``LM.init``), then the encoder's
        blocks, its ``pos_embed`` (``normal · 0.02``) and final norm."""
        cfg, dev = self.cfg, self.device
        params = self.decoder.init(generator)
        params["encoder"] = {
            "blocks": [
                [_block_init(generator, spec, cfg, device=dev) for spec in cfg.encoder_superblock]
                for _ in range(cfg.n_encoder_superblocks)
            ],
            "pos_embed": common.normal((cfg.encoder_frames, cfg.d_model), 0.02,
                                       generator=generator, device=dev),
            "final_norm": common.norm_init(cfg.d_model, cfg.norm, device=dev),
        }
        return params

    def _encoder_body(self, x: torch.Tensor, sb_params) -> torch.Tensor:
        for spec, p in zip(self.cfg.encoder_superblock, sb_params):
            x, _ = _block_forward(x, p, spec, self.cfg, impl=self.attn_impl,
                                  block_k=self.attn_block_k)
        return x

    def encode(self, params: Params, frames: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
        """frames [B, T, d] → the encoder's final-norm states [B, T, d] in
        the compute dtype: frames plus the first T rows of ``pos_embed``,
        cast, then the encoder superblocks."""
        enc = params["encoder"]
        x = (frames + enc["pos_embed"][:frames.shape[1]]).to(compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        for sb in enc["blocks"]:
            x = (checkpoint(self._encoder_body, x, sb, use_reentrant=False,
                            preserve_rng_state=False, context_fn=shard_lib.checkpoint_contexts)
                 if remat else self._encoder_body(x, sb))
        return common.norm(x, enc["final_norm"], self.cfg.norm)

    def forward(self, params: Params, tokens: torch.Tensor, frames: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
        """tokens int [B, S], frames [B, T, d] → logits [B, S, V]."""
        enc = self.encode(params, frames, compute_dtype)
        return self.decoder.forward(params, tokens, compute_dtype, context=enc)

    def loss(self, params: Params, tokens: torch.Tensor, frames: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
        """Next-token CE of the decoder over the encoded frames, as the
        reference's: no auxiliary term, and ``chunked_ce``'s default block
        (not ``ce_block``)."""
        enc = self.encode(params, frames, compute_dtype)
        x, _ = self.decoder.trunk(params, tokens, compute_dtype, context=enc)
        return _next_token_ce(x, self.decoder.head_weight(params), tokens, 512)
