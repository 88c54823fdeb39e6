"""Train, prefill and serve step factories.

Counterpart of ``repro/train/steps.py``: ``make_train_step`` for the
language model, ``make_tabular_train_step`` for the DLRM, and
``make_prefill_step`` / ``make_serve_step`` for serving.

The train steps work in place: ``train_step(params_or_model, opt_state,
batch) → metrics`` updates the parameters and ``opt_state`` and returns
``loss``, ``grad_norm`` and ``lr`` as device tensors, and nothing in the
step waits for the device.
"""

from __future__ import annotations

import torch

from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import leaves, tree_map


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
    """The LM's train step over ``{"tokens": int [B, S]}`` batches.

    ``train_step(params, opt_state, batch) → metrics``: ``model.loss``
    (with the MoE auxiliary loss, as the reference's), its backward,
    global-norm clipping and AdamW on ``params`` (made :func:`trainable`)
    and ``opt_state``, in place.

    ``microbatches > 1`` splits the batch on its leading axis into equal
    consecutive parts and accumulates the float32 gradient in the
    parameters' ``.grad`` as ``acc + g / microbatches`` (each part's
    backward runs on its loss over ``microbatches``; for a power of two
    that scaling is exact, so the sum is the reference's), with no
    accumulator of its own. The loss is the mean of the parts' losses.
    The gradients are dropped before the step returns.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be ≥ 1, got {microbatches}")

    def train_step(params, opt_state: dict, batch: dict) -> dict:
        extra = sorted(set(batch) - {"tokens"})
        if extra:
            raise NotImplementedError(
                f"batch keys {extra}: the port's LM takes tokens only; the audio and vision "
                "families come with cross-attention (ROADMAP queue 1 item 10, slice 18)")
        tokens = batch["tokens"]
        if tokens.shape[0] % microbatches:
            raise ValueError(f"batch of {tokens.shape[0]} rows does not split into "
                             f"{microbatches} microbatches")
        for p in leaves(trainable(params)):
            p.grad = None
        if microbatches == 1:
            loss = model.loss(params, tokens)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for micro in tokens.chunk(microbatches):
                part = model.loss(params, micro)
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
    int [B, S], without autograd."""

    @torch.no_grad()
    def prefill_step(params, batch: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
        x = model.hidden(params, batch["tokens"], compute_dtype)
        return x[:, -1] @ model.head_weight(params).to(x.dtype)

    return prefill_step


def make_serve_step(model):
    """``serve_step(params, state, token, pos) → (logits, state)``: one
    decode step, without autograd (MoE layers drop their auxiliary loss)."""

    @torch.no_grad()
    def serve_step(params, state, token, pos: int):
        return model.decode_step(params, token, state, pos)

    return serve_step
