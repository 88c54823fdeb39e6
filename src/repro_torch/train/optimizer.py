"""Optimizers (AdamW, SGD-momentum, Adafactor-lite) and LR schedules.

Counterpart of ``repro/train/optimizer.py``: each optimizer is an
(init, update) pair over trees of tensors (``train/tree.py``), and its
state mirrors the parameter tree leaf for leaf.

Unlike the reference's pure functions, the updates work **in place**: the
parameters (under ``torch.no_grad``), the gradients (clipping scales them)
and the state's tensors are overwritten, and the same trees are returned.
At the 1M point each of the tables, their gradient and AdamW's ``m`` and
``v`` is 6.66 GB, so a second copy of any of them matters. The step
counter is a device tensor, and the schedules and bias corrections are
computed from it on the device, so an update never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.train.tree import leaves, tree_map


# --------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------- #
def cosine_schedule(
    peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant_schedule(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=torch.float32, device=step.device)


# --------------------------------------------------------------------- #
# grad utilities
# --------------------------------------------------------------------- #
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, with no
    temporary the size of a leaf."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves(tree)]
    if not norms:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf **in place** so that the global norm is at most
    ``max_norm``. Returns ``(tree, norm before clipping)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        for x in leaves(tree):
            x.mul_(scale.to(x.dtype))
    return tree, norm


# --------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: Callable = dataclasses.field(default_factory=lambda: constant_schedule(1e-3))
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0


def _zeros(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)


def _step0(params) -> torch.Tensor:
    first = leaves(params)
    device = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params) -> dict:
    return {"m": _zeros(params), "v": _zeros(params), "step": _step0(params)}


def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, **in place** on
    ``params``, ``grads`` (clipped) and ``state``, with the reference's
    formula: ``m = b1·m + (1-b1)·g``, ``v = b2·v + (1-b2)·g²``, ``p -= lr ·
    ((m / bc1) / (sqrt(v / bc2) + eps) + wd·p)``, over every element,
    rows with a zero gradient included. Returns ``(params, state,
    {"grad_norm", "lr"})``, the metrics as device tensors."""
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    step = state["step"]
    step.add_(1)
    lr = cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            u.add_(p, alpha=cfg.weight_decay)
            p.sub_(u.mul_(lr))
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------- #
# SGD momentum (baseline / ablation)
# --------------------------------------------------------------------- #
def sgd_init(params) -> dict:
    return {"mom": _zeros(params), "step": _step0(params)}


def sgd_update(params, grads, state, lr: float = 1e-2, momentum: float = 0.9):
    """``mom = momentum·mom + g``; ``p -= lr·mom``, in place."""
    with torch.no_grad():
        for p, g, mom in zip(leaves(params), leaves(grads), leaves(state["mom"])):
            mom.mul_(momentum).add_(g)
            p.sub_(lr * mom)
    state["step"].add_(1)
    return params, state, {}


# --------------------------------------------------------------------- #
# Adafactor-lite (factored second moment — memory-lean option where full
# Adam state would not fit)
# --------------------------------------------------------------------- #
def adafactor_init(params) -> dict:
    def factored(x):
        if x.dim() >= 2:
            return {
                "vr": torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device),
                "vc": torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.float32,
                                  device=x.device),
            }
        return {"v": torch.zeros_like(x, dtype=torch.float32)}

    return {"v": tree_map(factored, params), "step": _step0(params)}


def adafactor_update(params, grads, state, lr: float = 1e-2, decay: float = 0.8):
    """The reference's Adafactor-lite step. Parameters update in place;
    each leaf's second-moment entries are replaced by new tensors in the
    state's own dicts."""
    step = state["step"]
    step.add_(1)
    beta = 1.0 - step.to(torch.float32) ** -decay
    with torch.no_grad():
        for p, g, v in zip(leaves(params), leaves(grads), _up_to(params, state["v"])):
            g32 = g.to(torch.float32)
            sq = g32 * g32 + 1e-30
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * sq.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * sq.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30)
                )
                v["vr"], v["vc"] = vr, vc
            else:
                v["v"] = beta * v["v"] + (1 - beta) * sq
                denom = torch.sqrt(v["v"])
            upd = g32 / torch.clamp(denom, min=1e-30)
            upd = upd / torch.clamp(global_norm(upd) / (upd.numel() ** 0.5), min=1.0)
            p.sub_(lr * upd)
    return params, state, {}


def _up_to(params, state_tree) -> list:
    """The subtrees of ``state_tree`` at the leaves of ``params``, in leaf
    order (the reference's ``treedef.flatten_up_to``)."""
    out = []
    tree_map(lambda _, sub: out.append(sub), params, state_tree)
    return out
