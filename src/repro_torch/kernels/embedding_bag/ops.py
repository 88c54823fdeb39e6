"""Public wrapper of the embedding-gather kernels (csrc/embedding_bag.cu).

``embedding_gather(tables, ids)`` is a ``torch.autograd.Function``: its
forward gathers one table row per (row, column) and its backward computes
the dense gradient of the tables. On CUDA tensors each launches its kernel,
once per call, at every table size (the reference's 8 MiB VMEM cutoff has
no counterpart: the tables stay in device memory), and a failed build or
launch raises. On CPU tensors each takes its plain version (``ref.py``).
The backward is deterministic on the card: the same inputs give the same
bits on every run.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ref

_P, _I = _build.PTR, _build.INT
KERNEL = _build.Kernel("embedding_bag", "embedding_gather", [_P, _P, _P, _I, _I, _I, _I, _I])
KERNEL_BACKWARD = _build.Kernel(
    "embedding_bag", "embedding_gather_backward",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
)
# One KERNEL_BACKWARD launch runs two kernels: the radix sort of each column
# beside the zeroing of the dense gradient (or after a memset of it, past
# ZERO_IN_KERNEL_MAX_BYTES), then the summing kernel. Their scratch, sized
# by backward_scratch, must match csrc/embedding_bag.cu:
_SEGMENT = 32  # sorted positions a warp of the summing kernel takes
_SORT_QUANTUM = 1024  # the sort block's 32 warps x 32 lanes
_SHARED_SORT_ROWS = 8192  # padded columns up to this sort in shared memory
_BULK_MAX_DIM = 256  # widest rows the summing kernel stages by bulk copies
# Gradients up to this many bytes are zeroed in the sort's launch (16-byte
# stores by the blocks that do not sort, under the sort); larger ones by a
# cudaMemsetAsync before it, which writes device memory faster than those
# blocks do (H100: 2.04 against 2.08-2.41 ms for the 6.66 GB at V = 10^6).
ZERO_IN_KERNEL_MAX_BYTES = 1 << 30


def zero_in_kernel(n_bytes: int) -> bool:
    """Whether the sort's launch zeroes a dense gradient of ``n_bytes``."""
    return n_bytes <= ZERO_IN_KERNEL_MAX_BYTES


def backward_scratch(batch: int, n_cols: int, dim: int) -> dict[str, tuple]:
    """Name → shape of each int32 scratch of the backward kernel (float32
    for ``partials``), for ``batch`` rows of ``n_cols`` columns: the sorted
    keys and rows, the device-memory sort buffers (empty when the padded
    column sorts in shared memory), each segment's run bounds and ticket,
    and the head and tail partials of each segment."""
    padded = max(1, -(-batch // _SORT_QUANTUM)) * _SORT_QUANTUM
    n_seg = -(-batch // _SEGMENT)
    return {
        "sorted": (n_cols, 2, padded),
        "sort_scratch": (n_cols, 4, padded) if padded > _SHARED_SORT_ROWS else (0,),
        "seg": (n_cols, n_seg, 2),
        "tickets": (n_cols, n_seg),
        "partials": (2, n_cols, n_seg, dim),
    }


def _check_sizes(batch: int, n_cols: int, vocab_range: int) -> None:
    if batch * n_cols >= 2**31 or n_cols * vocab_range >= 2**31:
        raise ValueError(
            f"batch {batch}, {n_cols} columns, vocab {vocab_range}: the kernels take "
            "fewer than 2**31 (row, column) pairs and table rows"
        )


def _gather(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    n_cols, vocab_range, dim = tables.shape
    dev = tables.device
    _build.check(tables, "tables", torch.float32)
    _build.check(ids, "ids", torch.int32, device=dev)
    if ids.dim() != 2 or ids.shape[1] != n_cols:
        raise ValueError(f"ids: expected [batch, {n_cols}], got {tuple(ids.shape)}")
    batch = int(ids.shape[0])
    _check_sizes(batch, n_cols, vocab_range)
    out = torch.empty((batch, n_cols, dim), dtype=torch.float32, device=dev)
    if batch and n_cols and dim:
        if vocab_range == 0:
            raise ValueError("tables: an empty vocabulary has no row to gather")
        vec4 = dim % 4 == 0 and tables.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        p = _build.ptr
        KERNEL.launch(dev, p(tables), p(ids), p(out), batch, n_cols, vocab_range, dim, int(vec4))
    return out


def _gather_backward(grad_out: torch.Tensor, ids: torch.Tensor, vocab_range: int) -> torch.Tensor:
    batch, n_cols, dim = grad_out.shape
    dev = grad_out.device
    _build.check(grad_out, "grad_out", torch.float32)
    _build.check(ids, "ids", torch.int32, (batch, n_cols), dev)
    _check_sizes(batch, n_cols, vocab_range)
    shapes = backward_scratch(batch, n_cols, dim)
    grad = torch.empty((n_cols, vocab_range, dim), dtype=torch.float32, device=dev)
    scratch = {name: torch.empty(shape, dtype=torch.float32 if name == "partials" else torch.int32,
                                 device=dev) for name, shape in shapes.items()}
    bulk = dim % 4 == 0 and dim <= _BULK_MAX_DIM and grad_out.data_ptr() % 16 == 0
    p = _build.ptr
    KERNEL_BACKWARD.launch(
        dev, p(grad), p(grad_out), p(ids), *(p(scratch[name]) for name in shapes),
        batch, n_cols, vocab_range, dim, shapes["sorted"][2], int(zero_in_kernel(grad.nbytes)),
        int(bulk),
    )
    return grad


class EmbeddingGather(torch.autograd.Function):
    """``tables [n_cols, V, dim]``, ``ids [batch, n_cols]`` → ``[batch,
    n_cols, dim]``, differentiable in ``tables``; the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, tables, ids):
        ctx.save_for_backward(ids)
        ctx.vocab_range = int(tables.shape[1])
        if tables.device.type == "cpu":
            return ref.embedding_gather(tables, ids)
        return _gather(tables, ids)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return embedding_gather_backward(grad_out.contiguous(), ids, ctx.vocab_range), None


def embedding_gather(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables f32 [n_cols, vocab, dim]; ids int32 [batch, n_cols]
    → f32 [batch, n_cols, dim], the reference's public layout."""
    return EmbeddingGather.apply(tables, ids)


def embedding_gather_backward(
    grad_out: torch.Tensor, ids: torch.Tensor, vocab_range: int
) -> torch.Tensor:
    """The dense gradient of the tables, outside autograd: the backward
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if grad_out.device.type == "cpu":
        return ref.embedding_gather_backward(grad_out, ids, vocab_range)
    return _gather_backward(grad_out, ids, vocab_range)
