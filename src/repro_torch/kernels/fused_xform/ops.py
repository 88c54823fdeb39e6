"""Public wrappers of the fused loop-② kernel (csrc/fused_xform.cu).

``fused_transform`` gathers straight from the device-resident table at
any vocab range, so loop ② has one route at 5K and at 1M; the
reference's VMEM/HBM tiers have no counterpart here. ``fused_mod_dense``
is the kernel without the gather (the reference's HBM-tier front half),
kept as a route so that the 1M choice can be made from a measurement.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build
from repro_torch.kernels.fused_xform import ref

_P, _I, _U64 = _build.PTR, _build.INT, ctypes.c_uint64
KERNEL = _build.Kernel(
    "fused_xform", "fused_transform", [_P, _P, _P, _P, _P, _I, _I, _I, _U64, _I, _U64]
)
KERNEL_MOD_DENSE = _build.Kernel(
    "fused_xform", "fused_mod_dense", [_P, _P, _P, _P, _I, _I, _I, _U64, _I, _U64]
)


def fastmod_magic(d: int) -> int:
    """``ceil(2**64 / d) mod 2**64``, the multiplier with which the kernel
    takes ``v mod d`` for every uint32 ``v`` (Lemire's fastmod; exact for
    ``1 <= d < 2**32``). ``d = 1`` gives 0, whose products are all 0."""
    if not 1 <= d < 2**32:
        raise ValueError(f"fastmod divisor {d} outside [1, 2**32)")
    return ((2**64 - 1) // d + 1) % 2**64


def _check_inputs(sparse: torch.Tensor, dense: torch.Tensor) -> None:
    rows = sparse.shape[0]
    _build.check(sparse, "sparse", torch.int32)
    _build.check(dense, "dense", torch.int32, device=sparse.device)
    if sparse.dim() != 2 or dense.dim() != 2 or dense.shape[0] != rows:
        raise ValueError(
            f"expected sparse [rows, n_sparse] and dense [rows, n_dense], got "
            f"{tuple(sparse.shape)} and {tuple(dense.shape)}"
        )
    if rows * max(sparse.shape[1], dense.shape[1]) >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 elements per matrix")


def _cols_magic(n_sparse: int) -> int:
    return fastmod_magic(n_sparse) if n_sparse else 0


def fused_transform(
    vocab: vocab_lib.Vocabulary, sparse: torch.Tensor, dense: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Loop ②'s per-chunk chain in one launch.

    sparse int32 [rows, n_sparse] (raw hash bitcasts); dense int32
    [rows, n_dense] → (ids int32 [rows, n_sparse], dense f32 [rows, n_dense]).
    """
    if sparse.device.type == "cpu":
        return ref.fused_transform(vocab.table, sparse, dense)
    _check_inputs(sparse, dense)
    rows, n_sparse = sparse.shape
    n_dense = dense.shape[1]
    dev = sparse.device
    _build.check(vocab.table, "table", torch.int32, device=dev)
    if vocab.table.shape[0] != n_sparse:
        raise ValueError(f"table has {vocab.table.shape[0]} columns, sparse {n_sparse}")
    ids = torch.empty((rows, n_sparse), dtype=torch.int32, device=dev)
    dense_out = torch.empty((rows, n_dense), dtype=torch.float32, device=dev)
    if rows:
        p = _build.ptr
        KERNEL.launch(
            dev, p(vocab.table), p(sparse), p(dense), p(ids), p(dense_out),
            rows, n_sparse, n_dense, _cols_magic(n_sparse), vocab.vocab_range,
            fastmod_magic(vocab.vocab_range),
        )
    return ids, dense_out


def fused_mod_dense(
    sparse: torch.Tensor, dense: torch.Tensor, *, vocab_range: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Modulus ∥ Neg2Zero+Logarithm in one launch → (modded int32
    [rows, n_sparse], dense f32 [rows, n_dense]); the caller gathers."""
    if sparse.device.type == "cpu":
        return ref.fused_mod_dense(sparse, dense, vocab_range)
    _check_inputs(sparse, dense)
    rows, n_sparse = sparse.shape
    n_dense = dense.shape[1]
    dev = sparse.device
    modded = torch.empty((rows, n_sparse), dtype=torch.int32, device=dev)
    dense_out = torch.empty((rows, n_dense), dtype=torch.float32, device=dev)
    if rows:
        p = _build.ptr
        KERNEL_MOD_DENSE.launch(
            dev, p(sparse), p(dense), p(modded), p(dense_out),
            rows, n_sparse, n_dense, _cols_magic(n_sparse), int(vocab_range),
            fastmod_magic(int(vocab_range)),
        )
    return modded, dense_out
