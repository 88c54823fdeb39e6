"""Public wrapper of the bytes-in loop-② kernel (csrc/fused_decode_xform.cu).

One launch per chunk from raw UTF-8 bytes to the final features. The
gather reads the table from device memory at any vocab range, and the
outputs are written straight to their own tensors, so the reference's
VMEM tiers and its ``[max_rows + 1, n_fields]`` staging table have no
counterpart. Any buffer length is taken, with no padding to a tile
multiple. A CPU buffer goes to the plain version. On the card, the
degenerate cases take the reference wrapper's own route — the decode
kernel, then the decoded-input loop-② kernel: no sparse or no dense
column, or an empty buffer.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build
from repro_torch.kernels.decode_utf8 import ops as decode_ops
from repro_torch.kernels.fused_decode_vocab.ref import hex_table
from repro_torch.kernels.fused_decode_xform import ref
from repro_torch.kernels.fused_xform import ops as fx_ops

_P, _I = _build.PTR, _build.INT
KERNEL = _build.Kernel(
    "fused_decode_xform",
    "fused_decode_transform",
    [_P, _build.INT64, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
)


def fused_decode_transform(
    vocab: vocab_lib.Vocabulary,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    hex_start: int,
    max_rows: int,
):
    """Loop ② straight from a raw UTF-8 chunk.

    byte_buf uint8 [B] — whole ``\\n``-terminated rows and zero padding,
    any length → (label int32 [max_rows], dense f32 [max_rows, n_dense],
    ids int32 [max_rows, n_sparse], valid bool [max_rows]), equal to
    decode + ``fused_transform`` on every row, padding rows included.
    """
    n_dense = hex_start - 1
    n_sparse = n_fields - hex_start
    if byte_buf.device.type == "cpu":
        return ref.fused_decode_transform(
            vocab, byte_buf, n_fields=n_fields, hex_start=hex_start, max_rows=max_rows
        )
    n = _build.check_bytes(byte_buf)
    if n_sparse == 0 or n_dense == 0 or n == 0:
        label, dense, sparse, valid = decode_ops.decode(
            byte_buf, hex_table(n_fields, hex_start), n_fields=n_fields,
            max_rows=max_rows, n_dense=n_dense, n_sparse=n_sparse,
        )
        ids, dense_out = fx_ops.fused_transform(vocab, sparse, dense)
        return label, dense_out, ids, valid
    dev = byte_buf.device
    vocab_range = vocab.vocab_range
    _build.check(vocab.table, "table", torch.int32, (n_sparse, vocab_range), dev)
    if max_rows * n_fields >= 2**31:
        raise ValueError(f"{max_rows} x {n_fields} cells; the kernel takes fewer than 2**31")
    scratch = _build.decode_scratch("fused_decode_xform", n, max_rows * n_fields, dev)
    label = torch.empty(max_rows, dtype=torch.int32, device=dev)
    dense = torch.empty((max_rows, n_dense), dtype=torch.float32, device=dev)
    ids = torch.empty((max_rows, n_sparse), dtype=torch.int32, device=dev)
    valid = torch.empty(max_rows, dtype=torch.bool, device=dev)
    p = _build.ptr
    KERNEL.launch(
        dev, p(byte_buf), n, max_rows, n_fields, hex_start, vocab_range, p(scratch),
        p(vocab.table), p(label), p(dense), p(ids), p(valid),
    )
    return label, dense, ids, valid
