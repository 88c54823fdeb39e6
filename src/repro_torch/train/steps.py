"""Train, prefill and serve step factories.

Counterpart of ``repro/train/steps.py``: ``make_tabular_train_step`` for
the DLRM, and ``make_prefill_step`` / ``make_serve_step`` for the
language model. The LM's ``make_train_step`` comes with LM training
(ROADMAP queue 1 item 12).
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
    [B,S,V] logits of ``forward`` are never needed at prefill).

    ``prefill_step(params, batch) → logits [B, V]`` over ``batch["tokens"]``
    int [B, S], without autograd."""

    @torch.no_grad()
    def prefill_step(params, batch: dict, compute_dtype=torch.bfloat16) -> torch.Tensor:
        x = model.hidden(params, batch["tokens"], compute_dtype)
        return x[:, -1] @ model.head_weight(params).to(x.dtype)

    return prefill_step


def make_serve_step(model):
    """``serve_step(params, state, token, pos) → (logits, state)``: one
    decode step, without autograd."""

    @torch.no_grad()
    def serve_step(params, state, token, pos: int):
        return model.decode_step(params, token, state, pos)

    return serve_step
