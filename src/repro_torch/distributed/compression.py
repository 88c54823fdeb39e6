"""Gradient compression: an int8 all-reduce with error feedback.

Counterpart of ``repro/distributed/compression.py``, with its arithmetic
step for step: a symmetric per-tensor int8 code (``scale = max(amax,
1e-12) / 127``, round half to even, clip to ±127), the int8 codes summed
in int32, and the mean taken as ``q_sum · scale / n``. Error feedback
(Karimireddy et al., 2019) adds each step's residual back before the next
quantization, so the quantization bias does not accumulate. Compressing
the data-parallel gradient reduction 4× (float32 → int8 and one scale per
leaf) cuts its collective's bytes in proportion.

:func:`compressed_psum_mean` comes in two forms: over leaves that carry a
leading shard axis ``[n, ...]`` in one process (the reference's
``shard_map`` over the data axes, its positions one after another), and
over a ``torch.distributed`` group (``group=``): an ``all_reduce`` MAX of
each leaf's absolute maximum, then a SUM of its int32 codes. The
``Trainer`` does not call it, as the reference's does not.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.tree import leaves, tree_map

Params = Any


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _code(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns ``(q, scale)``."""
    scale = _scale(torch.max(torch.abs(x)))
    return _code(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(x: torch.Tensor, err: torch.Tensor):
    """One error-feedback round on a local tensor (no collective): returns
    ``(x_hat, new_err)`` with ``x_hat = Q⁻¹(Q(x + err))``."""
    y = x.to(torch.float32) + err
    q, scale = quantize_int8(y)
    x_hat = dequantize_int8(q, scale)
    return x_hat, y - x_hat


def _leaf_mean(g: torch.Tensor, e: torch.Tensor):
    """One leaf ``[n, ...]``: the shared scale from the shards' largest
    |y|, each shard's code, their int32 sum, the mean and the residuals."""
    n = g.shape[0]
    y = g.to(torch.float32) + e
    scale = _scale(torch.max(torch.abs(y)))
    q = _code(y, scale)
    q_sum = torch.sum(q.to(torch.int32), dim=0, dtype=torch.int32)
    mean = q_sum.to(torch.float32) * scale / n
    return mean, y - dequantize_int8(q, scale)


def compressed_psum_mean(grads: Params, err: Params, *, group=None):
    """Error-feedback int8 all-reduce-mean.

    Without ``group``: each leaf of ``grads`` carries a leading shard axis
    ``[n_shards, ...]`` (per-shard local gradients, before the data-parallel
    reduction) and ``err`` the matching per-shard residuals. Returns
    ``(mean_grads without the shard axis, new_err)``.

    With ``group`` (a ``torch.distributed`` process group, or
    ``torch.distributed.group.WORLD``): each rank passes its own local
    leaves and residuals, without a shard axis, and gets the mean over the
    group's ranks and its own new residuals. One MAX all-reduce of a
    scalar a leaf sets the shared scale, one SUM of int32 codes the sum;
    the payload is 1 byte an element and a scale (int32 on the wire).
    """
    if group is None:
        pairs = [_leaf_mean(g, e) for g, e in zip(leaves(grads), leaves(err))]
    else:
        pairs = [_leaf_mean_group(g, e, group) for g, e in zip(leaves(grads), leaves(err))]
    means, errs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return tree_map(lambda _: next(means), grads), tree_map(lambda _: next(errs), grads)


def _leaf_mean_group(g: torch.Tensor, e: torch.Tensor, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    y = g.to(torch.float32) + e
    amax = torch.max(torch.abs(y)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(amax[0])
    q = _code(y, scale)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    mean = q_sum.to(torch.float32) * scale / n
    return mean, y - dequantize_int8(q, scale)


def error_state_init(params: Params) -> Params:
    """Zero float32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
