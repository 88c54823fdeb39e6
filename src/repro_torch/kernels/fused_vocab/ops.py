"""Public wrapper of the fused loop-① kernel (csrc/fused_vocab.cu).

One kernel covers every vocab range, with or without the count plane:
``atomicMin`` on the int32 state is order-independent, so the state is
bit-identical to the reference's scatter-min at any range, and the
reference's memory tiers (vmem / hbm_slab / xla_fallback) have no
counterpart here. The kernel needs no row padding either: it masks the
ragged edge itself.

The kernel's blocks count the valid rows into a 64-bit tally in device
memory, which the last block puts back to 0. The wrapper keeps one tally
per (device, stream), zeroed when it is made (:func:`tally`): launches on
one stream run one after another, and two streams never share one.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build
from repro_torch.kernels.fused_vocab import ref

_P, _I = _build.PTR, _build.INT
KERNEL = _build.Kernel(
    "fused_vocab", "fused_genvocab", [_P, _P, _P, _P, _P, _P, _I, _I, _I]
)
KERNEL_COUNTS = _build.Kernel(
    "fused_vocab", "fused_genvocab_counts", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
)
_tallies: dict[tuple[torch.device, int], torch.Tensor] = {}


def tally(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's int64 [1] row tally for launches on ``stream`` (a
    stream handle) of ``device``: made zeroed at first use, then kept, and
    left at 0 by every launch."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, stream)
    t = _tallies.get(key)
    if t is None:
        t = _tallies[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def fused_update(
    state: vocab_lib.VocabState, sparse: torch.Tensor, valid: torch.Tensor
) -> vocab_lib.VocabState:
    """Loop ①'s per-chunk chain in one launch.

    sparse int32 [rows, n_cols] (raw hash bitcasts, pre-modulus); valid
    bool [rows] → the updated state, bit-identical to
    ``vocab.update(state, positive_modulus(sparse, V), valid)``.

    **Updates ``state.first_pos`` and ``state.counts`` in place** (the
    reference donates them): thread the returned state through and do not
    read the old one. Positions are ``vocab.positions``: uint32 from
    ``rows_seen``, saturating at ``NEVER``, ``NEVER`` for invalid rows.
    """
    rows, n_cols = sparse.shape
    n_state, vocab_range = state.first_pos.shape
    if n_state != n_cols:
        raise ValueError(f"sparse has {n_cols} columns, the state {n_state}")
    vocab_lib.check_row_ceiling(state.rows_seen, rows)
    track_counts = state.counts is not None
    if sparse.device.type == "cpu":
        rows_seen = ref.fused_genvocab(
            state.first_pos, state.counts, sparse, valid, state.rows_seen
        )
        return vocab_lib.VocabState(state.first_pos, rows_seen, state.counts)
    if rows == 0 or n_cols == 0:
        rows_seen = vocab_lib.advance_rows_seen(
            state.rows_seen, valid.to(torch.int32).sum()
        )
        return vocab_lib.VocabState(state.first_pos, rows_seen, state.counts)
    dev = sparse.device
    _build.check(sparse, "sparse", torch.int32)
    _build.check(valid, "valid", torch.bool, (rows,), dev)
    _build.check(state.first_pos, "first_pos", torch.int32, device=dev)
    _build.check(state.rows_seen, "rows_seen", torch.int32, (), dev)
    if rows * n_cols >= 2**31:
        raise ValueError(f"{rows} x {n_cols} elements; the kernel takes fewer than 2**31")
    rows_seen = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    rows_tally = p(tally(dev, torch.cuda.current_stream(dev).cuda_stream))
    if track_counts:
        _build.check(state.counts, "counts", torch.int32, state.first_pos.shape, dev)
        KERNEL_COUNTS.launch(
            dev, p(state.first_pos), p(state.counts), p(sparse), p(valid),
            p(state.rows_seen), p(rows_seen), rows_tally, rows, n_cols, vocab_range,
        )
    else:
        KERNEL.launch(
            dev, p(state.first_pos), p(sparse), p(valid), p(state.rows_seen),
            p(rows_seen), rows_tally, rows, n_cols, vocab_range,
        )
    return vocab_lib.VocabState(state.first_pos, rows_seen, state.counts)
