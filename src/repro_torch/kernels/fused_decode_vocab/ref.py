"""Plain PyTorch version of the bytes-in loop-① step.

Counterpart of ``repro/kernels/fused_decode_vocab/ref.py``: the
composition the kernel replaces — the plain decode
(``decode_utf8/ref.py``), the uint32 Modulus, then ``vocab.update``. The
kernel must give the same state bit for bit: padding rows carry ``NEVER``
positions (the min identity), and ``rows_seen`` advances by the valid-row
count, ``min(#newlines, max_rows)``.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels.decode_utf8 import ref as decode_ref


def hex_table(n_fields: int, hex_start: int) -> torch.Tensor:
    """The contiguous decimal-then-hex layout the bytes-in kernels assume."""
    return torch.arange(n_fields) >= hex_start


def fused_decode_genvocab(
    state: vocab_lib.VocabState,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    hex_start: int,
    max_rows: int,
) -> vocab_lib.VocabState:
    """Bytes-in loop-① step: decode → Modulus → scatter-min; returns a new
    state."""
    _, _, sparse, valid = decode_ref.decode_bytes(
        byte_buf,
        hex_table(n_fields, hex_start),
        n_fields=n_fields,
        max_rows=max_rows,
        n_dense=hex_start - 1,
        n_sparse=n_fields - hex_start,
    )
    modded = core_ops.positive_modulus(sparse, int(state.first_pos.shape[1]))
    return vocab_lib.update(state, modded, valid)
