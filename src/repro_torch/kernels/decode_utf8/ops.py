"""Public wrapper of the decode kernel (csrc/decode_utf8.cu).

``decode`` mirrors the signature of ``ref.decode_bytes``. The kernel is
hard-wired to the contiguous decimal-then-hex column layout (label and
dense decimal fields first, hex fields from ``1 + n_dense`` on), so the
wrapper **validates** ``hex_field_table`` against that layout and raises
instead of decoding garbage for a permuted schema — on either device, as
the reference's wrapper does. A CPU buffer goes to the plain version; a
CUDA buffer launches the kernel.

The kernel is one launch: a single-pass chained scan over the chunk's
tiles (csrc/lookback.cuh), whose status words must read "not yet
published" at the start of every call without a fill. The wrapper keeps
one :class:`ScanScratch` per (device, stream), zeroed when it is made, and
gives each call a new epoch, which the kernel writes into every status
word: launches on one stream run one after another, and launches on two
streams never share a scratch. No block of a launch waits on one that has
not started, so decodes on two streams may run at once at any chunk size.
A CUDA graph would replay one epoch forever, so ``decode`` refuses to be
captured.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_utf8 import ref

KERNEL = _build.Kernel(
    "decode_utf8",
    "decode_utf8",
    [_build.PTR, _build.INT64, _build.INT, _build.INT, _build.INT, _build.INT,
     _build.INT, _build.PTR, _build.INT, _build.PTR, _build.PTR, _build.PTR, _build.PTR],
)
# The high half of a status word holds epoch << 2 | flag.
EPOCH_LIMIT = 1 << 30


class ScanScratch:
    """The look-back scratch of the launches on one stream: int32 words,
    zeroed when made, and the epoch of the last call."""

    def __init__(self, ints: int, device: torch.device):
        self.words = torch.zeros(ints, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        """The next call's epoch, in [1, EPOCH_LIMIT). When the epochs run
        out, the words are zeroed (on the current stream, so after every
        launch that used them) and the count starts again at 1: a word of
        an earlier call could otherwise carry a reused epoch."""
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:
            self.words.zero_()
            self.epoch = 1
        return self.epoch


_scratches: dict[tuple[torch.device, int], ScanScratch] = {}


def scan_scratch(device: torch.device, stream: int, ints: int) -> ScanScratch:
    """The scratch for launches on ``stream`` (a stream handle) of
    ``device``, at least ``ints`` words: kept from the last call, or made
    anew (zeroed, epochs from 1) at first use and when a chunk needs more
    tiles than it holds."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, stream)
    s = _scratches.get(key)
    if s is None or s.words.numel() < ints:
        s = _scratches[key] = ScanScratch(ints, device)
    return s


_scratch_ints_fn = None


def _scratch_ints(n: int) -> int:
    """The scratch words a call on an ``n``-byte chunk needs (from the
    kernel library, which knows its tile size)."""
    global _scratch_ints_fn
    if _scratch_ints_fn is None:
        fn = _build.library("decode_utf8").decode_scan_scratch_ints
        fn.argtypes = [_build.INT64]
        fn.restype = _build.INT64
        _scratch_ints_fn = fn
    return _scratch_ints_fn(n)


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
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "decode cannot be captured in a CUDA graph: each call needs a new "
            "epoch for its look-back scratch, and a replay would reuse one"
        )
    dev = byte_buf.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = scan_scratch(dev, stream, _scratch_ints(n))
    label = torch.empty(max_rows, dtype=torch.int32, device=dev)
    dense = torch.empty((max_rows, n_dense), dtype=torch.int32, device=dev)
    sparse = torch.empty((max_rows, n_sparse), dtype=torch.int32, device=dev)
    valid = torch.empty(max_rows, dtype=torch.bool, device=dev)
    p = _build.ptr
    KERNEL.launch(
        dev, p(byte_buf), n, max_rows, n_fields, 1 + n_dense, n_dense, n_sparse,
        p(scratch.words), scratch.next_epoch(), p(label), p(dense), p(sparse), p(valid),
    )
    return label, dense, sparse, valid
