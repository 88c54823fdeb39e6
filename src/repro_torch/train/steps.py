"""Train, prefill and serve step factories.

Counterpart of ``repro/train/steps.py``: ``make_train_step`` for the
language model, ``make_tabular_train_step`` for the DLRM, and
``make_prefill_step`` / ``make_serve_step`` for serving.

The train steps work in place: ``train_step(params_or_model, opt_state,
batch) → metrics`` updates the parameters and ``opt_state`` and returns
``loss``, ``grad_norm`` and ``lr`` as device tensors, and nothing in the
step waits for the device.

A language model's batch is the reference's dict:
    tokens  int  [B, S]                        (always)
    frames  f32  [B, frames, d_model]          (EncDec: the stub frontend)
    vision  f32  [B, vision_tokens, d_model]   (LM: the cross layers' context)
"""

from __future__ import annotations

import torch

from repro_torch.models import lm as lm_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import leaves, tree_map


def _batch_keys(model) -> set:
    return {"tokens", "frames"} if isinstance(model, lm_lib.EncDec) else {"tokens", "vision"}


def _model_loss(model, params, batch: dict) -> torch.Tensor:
    if isinstance(model, lm_lib.EncDec):
        return model.loss(params, batch["tokens"], batch["frames"])
    return model.loss(params, batch["tokens"], context=batch.get("vision"))


def value_and_grad(loss_fn, model, batch: dict):
    """``loss_fn(model, batch)`` and the gradient of every parameter of
    ``model.params_tree()``, as ``(loss, grads)``: the loss detached, the
    gradients in the parameter tree (the parameters' ``.grad`` tensors,
    which this call sets anew)."""
    params = model.params_tree()
    for p in leaves(params):
        p.grad = None
    loss = loss_fn(model, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, params)


def trainable(params):
    """Turn gradients on for every leaf of an LM parameter tree (``LM.init``
    makes plain tensors, which prefill and serving use as they are).
    Returns the same tree."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def make_train_step(model, opt_cfg: opt_lib.AdamWConfig, microbatches: int = 1):
    """The train step of an ``LM`` or ``EncDec`` over the batches of the
    module's docstring (``frames`` for an ``EncDec``, ``vision`` optional
    for an ``LM``; any other key raises).

    ``train_step(params, opt_state, batch) → metrics``: ``model.loss``
    (with the MoE auxiliary loss, as the reference's), its backward,
    global-norm clipping and AdamW on ``params`` (made :func:`trainable`)
    and ``opt_state``, in place.

    ``microbatches > 1`` splits every array of the batch on its leading
    axis into equal consecutive parts and accumulates the float32 gradient
    in the parameters' ``.grad`` as ``acc + g / microbatches`` (each part's
    backward runs on its loss over ``microbatches``; for a power of two
    that scaling is exact, so the sum is the reference's), with no
    accumulator of its own. The loss is the mean of the parts' losses.
    The gradients are dropped before the step returns.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be ≥ 1, got {microbatches}")

    keys = _batch_keys(model)

    def train_step(params, opt_state: dict, batch: dict) -> dict:
        extra = sorted(set(batch) - keys)
        if extra:
            raise ValueError(f"batch keys {extra}: {type(model).__name__}'s batches hold "
                             f"{sorted(keys)}")
        tokens = batch["tokens"]
        rows = {k: v.shape[0] for k, v in batch.items()}
        if tokens.shape[0] % microbatches or len(set(rows.values())) != 1:
            raise ValueError(f"batch rows {rows} do not split into {microbatches} microbatches "
                             "alike")
        for p in leaves(trainable(params)):
            p.grad = None
        if microbatches == 1:
            loss = _model_loss(model, params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            for i in range(microbatches):
                part = _model_loss(model, params, {k: v[i] for k, v in parts.items()})
                (part / microbatches).backward()
                loss = loss + part.detach() / microbatches
        grads = tree_map(lambda p: p.grad, params)
        _, _, metrics = opt_lib.adamw_update(params, grads, opt_state, opt_cfg)
        for p in leaves(params):
            p.grad = None
        metrics["loss"] = loss
        return metrics

    return train_step


def make_tabular_train_step(loss_fn, opt_cfg: opt_lib.AdamWConfig):
    """Train step over a batch-loss callable, e.g. ``repro_torch.models.
    dlrm.loss`` over ``{label, dense, sparse}`` batches
    (``train/input_pipeline.py``).

    ``train_step(model, opt_state, batch) → metrics``: forward, backward,
    global-norm clipping and AdamW, updating the model's parameters and
    ``opt_state`` in place. ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr`` as device tensors; nothing in the step waits for the device.
    The gradients are dropped before it returns (at the 1M point the
    tables' is 6.66 GB).
    """

    def train_step(model, opt_state: dict, batch: dict) -> dict:
        loss, grads = value_and_grad(loss_fn, model, batch)
        params = model.params_tree()
        _, _, metrics = opt_lib.adamw_update(params, grads, opt_state, opt_cfg)
        for p in leaves(params):
            p.grad = None
        metrics["loss"] = loss
        return metrics

    return train_step


def make_prefill_step(model):
    """Prefill = trunk over the prompt + last-position head only (the full
    [B,S,V] logits of ``forward`` are never needed at prefill); the MoE
    auxiliary loss is dropped, as the reference drops it.

    ``prefill_step(params, batch) → logits [B, V]`` over ``batch["tokens"]``
    int [B, S], without autograd: an ``EncDec`` encodes ``batch["frames"]``
    first, an ``LM`` passes ``batch.get("vision")`` to its cross layers."""

    @torch.no_grad()
    def prefill_step(params, batch: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
        if isinstance(model, lm_lib.EncDec):
            decoder, context = model.decoder, model.encode(params, batch["frames"], compute_dtype)
        else:
            decoder, context = model, batch.get("vision")
        x = decoder.hidden(params, batch["tokens"], compute_dtype, context=context)
        return x[:, -1] @ decoder.head_weight(params).to(x.dtype)

    return prefill_step


def make_serve_step(model):
    """``serve_step(params, state, token, pos) → (logits, state)``: one
    decode step, without autograd (MoE layers drop their auxiliary loss),
    through ``model.decoder`` for an ``EncDec``."""
    decoder = model.decoder if isinstance(model, lm_lib.EncDec) else model

    @torch.no_grad()
    def serve_step(params, state, token, pos: int):
        return decoder.decode_step(params, token, state, pos)

    return serve_step
