"""Plain PyTorch version of the bytes-in loop-② step.

Counterpart of ``repro/kernels/fused_decode_xform/ref.py``: the plain
decode (``decode_utf8/ref.py``), then the unfused loop-② chain — uint32
Modulus → ``vocab.lookup`` ∥ Neg2Zero + Logarithm. Labels and ids must
match the kernel bit for bit and dense values to rtol 1e-6, padding rows
included.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels.decode_utf8 import ref as decode_ref
from repro_torch.kernels.fused_decode_vocab.ref import hex_table


def fused_decode_transform(
    vocab: vocab_lib.Vocabulary,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    hex_start: int,
    max_rows: int,
):
    """→ (label int32 [max_rows], dense f32 [max_rows, hex_start - 1],
    ids int32 [max_rows, n_fields - hex_start], valid bool [max_rows])."""
    label, dense, sparse, valid = decode_ref.decode_bytes(
        byte_buf,
        hex_table(n_fields, hex_start),
        n_fields=n_fields,
        max_rows=max_rows,
        n_dense=hex_start - 1,
        n_sparse=n_fields - hex_start,
    )
    modded = core_ops.positive_modulus(sparse, vocab.vocab_range)
    return label, core_ops.dense_transform(dense), vocab_lib.lookup(vocab, modded), valid
