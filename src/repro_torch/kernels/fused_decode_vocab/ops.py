"""Public wrapper of the bytes-in loop-① kernel (csrc/fused_decode_vocab.cu).

One launch per chunk from raw UTF-8 bytes to the updated state, and no
other device work, at every vocab range: ``atomicMin`` on the int32 state
in device memory needs no memory tier, so the reference's VMEM budget and
its decoded-input fallback for large ranges have no counterpart. Any
buffer length is taken, with no padding to a tile multiple. The kernel is
decode's single-pass look-back scan (csrc/decode_tiles.cuh); its scratch
and epochs are decode's (``_scratch.scan_call``), so a CUDA graph capture
raises, as it does for decode, and its pending list is kept per (device,
stream) (``_scratch.pending``). A CPU buffer goes to the plain version.
On the card, the degenerate cases take the reference wrapper's own route
— the decode kernel, then the decoded-input loop-① kernel: no sparse
column, an empty buffer, or a state that tracks counts (the bytes-in
kernel carries no count plane).
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build, _scratch
from repro_torch.kernels.decode_utf8 import ops as decode_ops
from repro_torch.kernels.fused_decode_vocab import ref
from repro_torch.kernels.fused_vocab import ops as fv_ops

_P, _I = _build.PTR, _build.INT
KERNEL = _build.Kernel(
    "fused_decode_vocab",
    "fused_decode_genvocab",
    [_P, _build.INT64, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P],
)
LAUNCH_ENTRIES = {"fused_decode_genvocab": 0}  # C symbol → entry of its launch_config


def launch_accounting(symbol: str, n_bytes: int) -> list[dict]:
    """The launches of ``symbol`` on an ``n_bytes`` chunk, as
    ``fused_decode_vocab_launch_config`` reports them: decode's tile scan."""
    if symbol not in LAUNCH_ENTRIES:
        raise ValueError(f"fused_decode_vocab has no entry point {symbol!r}")
    return decode_ops.tiles_launch(n_bytes)


@_build.entry(KERNEL)
def fused_decode_update(
    state: vocab_lib.VocabState,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    hex_start: int,
    max_rows: int,
) -> vocab_lib.VocabState:
    """Loop ① straight from a raw UTF-8 chunk.

    byte_buf uint8 [B] — whole ``\\n``-terminated rows and zero padding,
    any length → the updated state, bit-identical to decode →
    ``positive_modulus`` → ``vocab.update`` with positions from
    ``state.rows_seen``.

    On the card it **updates ``state.first_pos`` in place** (the reference
    donates it): thread the returned state through and do not read the
    old one. ``rows_seen`` advances by ``min(#newlines, max_rows)``,
    counted on the device.
    """
    n_cols = n_fields - hex_start
    # Host-side ceiling guard (at most max_rows rows per chunk); a no-op on
    # the card, where the kernel's positions saturate.
    vocab_lib.check_row_ceiling(state.rows_seen, max_rows)
    if byte_buf.device.type == "cpu":
        return ref.fused_decode_genvocab(
            state, byte_buf, n_fields=n_fields, hex_start=hex_start, max_rows=max_rows
        )
    n = _build.check_bytes(byte_buf)
    if n_cols <= 0 or n == 0 or state.counts is not None:
        _, _, sparse, valid = decode_ops.decode(
            byte_buf, ref.hex_table(n_fields, hex_start), n_fields=n_fields,
            max_rows=max_rows, n_dense=hex_start - 1, n_sparse=n_cols,
        )
        return fv_ops.fused_update(state, sparse, valid)
    dev = byte_buf.device
    vocab_range = int(state.first_pos.shape[1])
    _build.check(state.first_pos, "first_pos", torch.int32, (n_cols, vocab_range), dev)
    _build.check(state.rows_seen, "rows_seen", torch.int32, (), dev)
    if max_rows * n_fields >= 2**31:
        raise ValueError(f"{max_rows} x {n_fields} cells; the kernel takes fewer than 2**31")
    # the 64-bit counts and a word of padding, then (cell, slot) of each
    # sparse cell the kernel may have to hold back (csrc/fused_decode_vocab.cu)
    pending = _scratch.pending(
        dev, torch.cuda.current_stream(dev).cuda_stream, 4 + 2 * max_rows * n_cols)
    rows_seen = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    scratch = _scratch.scan_call(dev, n, "fused_decode_genvocab")
    with scratch.lock:
        KERNEL.launch(
            dev, p(byte_buf), n, max_rows, n_fields, hex_start, vocab_range, p(scratch.words),
            scratch.next_epoch(), p(pending), p(state.first_pos), p(state.rows_seen),
            p(rows_seen),
        )
    return vocab_lib.VocabState(state.first_pos, rows_seen)
