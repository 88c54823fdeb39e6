"""Public wrapper of the decode kernel (csrc/decode_utf8.cu).

``decode`` mirrors the signature of ``ref.decode_bytes``. The kernel is
hard-wired to the contiguous decimal-then-hex column layout (label and
dense decimal fields first, hex fields from ``1 + n_dense`` on), so the
wrapper **validates** ``hex_field_table`` against that layout and raises
instead of decoding garbage for a permuted schema — on either device, as
the reference's wrapper does. A CPU buffer goes to the plain version; a
CUDA buffer launches the kernel.

The kernel is one launch: a single-pass chained scan over the chunk's
tiles (csrc/decode_tiles.cuh on csrc/lookback.cuh), whose status words
must read "not yet published" at the start of every call without a fill.
It takes the per-(device, stream) scratch and a new epoch from
``_scratch.scan_call``, which the bytes-in loop-② kernel
(``fused_decode_xform``) shares, and launches under that scratch's lock;
so a CUDA graph capture raises. No block
of a launch waits on one that has not started, so decodes on two streams
may run at once at any chunk size.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._scratch import scan_call
from repro_torch.kernels.decode_utf8 import ref

KERNEL = _build.Kernel(
    "decode_utf8",
    "decode_utf8",
    [_build.PTR, _build.INT64, _build.INT, _build.INT, _build.INT, _build.INT,
     _build.INT, _build.PTR, _build.INT, _build.PTR, _build.PTR, _build.PTR, _build.PTR],
)
# csrc/decode_tiles.cuh, shared by every kernel that reads raw bytes: a block
# of TILE_THREADS threads per TILE_BYTES tile, then TRAILING blocks.
TILE_THREADS, TILE_BYTES, TRAILING = 1024, 8192, 32
LAUNCH_ENTRIES = {"decode_utf8": 0}  # C symbol → entry of decode_utf8_launch_config


def tiles_launch(n_bytes: int) -> list[dict]:
    """The one launch of ``decode_tiles_kernel`` (csrc/decode_tiles.cuh) over
    an ``n_bytes`` chunk: a block per 8 KiB tile and 32 trailing blocks of
    1024 threads, static shared memory only."""
    return [_build.launch_record("decode_tiles_kernel", (-(-n_bytes // TILE_BYTES) + TRAILING,),
                                 TILE_THREADS)]


def launch_accounting(symbol: str, n_bytes: int) -> list[dict]:
    """The launches of ``symbol`` on an ``n_bytes`` chunk, as
    ``decode_utf8_launch_config`` reports them."""
    if symbol not in LAUNCH_ENTRIES:
        raise ValueError(f"decode_utf8 has no entry point {symbol!r}")
    return tiles_launch(n_bytes)


def _check_layout(hex_field_table, n_fields: int, n_dense: int) -> None:
    """Raise unless the table is the contiguous decimal-then-hex layout.
    (A CUDA tensor is read back to the host; the pipeline passes numpy.)"""
    if isinstance(hex_field_table, torch.Tensor):
        hex_field_table = hex_field_table.cpu().numpy()
    table = np.asarray(hex_field_table).astype(bool)
    expected = np.zeros(n_fields, dtype=bool)
    expected[1 + n_dense :] = True
    if table.shape != (n_fields,) or not np.array_equal(table, expected):
        raise ValueError(
            "decode kernel requires the contiguous decimal-then-hex layout "
            f"(hex fields exactly at [{1 + n_dense}, {n_fields})); got "
            f"hex_field_table with hex columns at "
            f"{np.flatnonzero(table).tolist()} — use the ref decoder "
            "(kernels/decode_utf8/ref.py) for permuted schemas"
        )


@_build.entry(KERNEL)
def decode(
    byte_buf: torch.Tensor,
    hex_field_table,
    *,
    n_fields: int,
    max_rows: int,
    n_dense: int,
    n_sparse: int,
):
    """Decode one padded UTF-8 chunk of whole rows.

    byte_buf uint8 [B] → (label int32 [max_rows], dense int32 [max_rows,
    n_dense], sparse int32 [max_rows, n_sparse], valid bool [max_rows]),
    equal to ``ref.decode_bytes`` on every cell, padding rows included.
    """
    _check_layout(hex_field_table, n_fields, n_dense)
    if byte_buf.device.type == "cpu":
        return ref.decode_bytes(
            byte_buf,
            hex_field_table,
            n_fields=n_fields,
            max_rows=max_rows,
            n_dense=n_dense,
            n_sparse=n_sparse,
        )
    n = _build.check_bytes(byte_buf)
    if n_fields != 1 + n_dense + n_sparse:
        raise ValueError(f"n_fields={n_fields} != 1 + {n_dense} + {n_sparse}")
    if max_rows * n_fields >= 2**31:
        raise ValueError(f"{max_rows} x {n_fields} cells; the kernel takes fewer than 2**31")
    dev = byte_buf.device
    label = torch.empty(max_rows, dtype=torch.int32, device=dev)
    dense = torch.empty((max_rows, n_dense), dtype=torch.int32, device=dev)
    sparse = torch.empty((max_rows, n_sparse), dtype=torch.int32, device=dev)
    valid = torch.empty(max_rows, dtype=torch.bool, device=dev)
    p = _build.ptr
    scratch = scan_call(dev, n, "decode")
    with scratch.lock:
        KERNEL.launch(
            dev, p(byte_buf), n, max_rows, n_fields, 1 + n_dense, n_dense, n_sparse,
            p(scratch.words), scratch.next_epoch(), p(label), p(dense), p(sparse), p(valid),
        )
    return label, dense, sparse, valid
