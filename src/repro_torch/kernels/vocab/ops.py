"""Public wrappers of the per-op vocabulary kernels (csrc/vocab.cu).

``genvocab_update`` is loop ①'s GenVocab on modded values and
``apply_vocab`` loop ②'s ApplyVocab, the route of
``PipelineConfig(use_kernels=True)`` when the fused hints are off. Each is
one launch per chunk at **every** vocab range, 1M included: ``atomicMin``
on the int32 state and the gather both work in device memory, so the
reference's cutoff (ranges above ``VMEM_TIER_MAX`` = 512Ki go to its XLA
oracle) has no counterpart. A CPU tensor goes to the plain version
(``ref.py``); a CUDA tensor always launches the kernel, and a failed build
or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build
from repro_torch.kernels.vocab import ref

_P, _I = _build.PTR, _build.INT
KERNEL_GENVOCAB = _build.Kernel("vocab", "genvocab", [_P, _P, _P, _P, _I, _I, _I])
KERNEL_APPLY = _build.Kernel("vocab", "apply_vocab", [_P, _P, _P, _I, _I, _I])


def _check_elements(rows: int, n_cols: int) -> None:
    if rows * n_cols >= 2**31:
        raise ValueError(f"{rows} x {n_cols} elements; the kernel takes fewer than 2**31")


def genvocab_update(
    state: vocab_lib.VocabState, modded: torch.Tensor, valid: torch.Tensor
) -> vocab_lib.VocabState:
    """Absorb one chunk of modded values into the first-occurrence state.

    modded int32 [rows, n_cols] in ``[0, vocab_range)``; valid bool [rows]
    → the updated state, bit-identical to ``vocab.update``. Positions are
    ``vocab.positions`` and the new ``rows_seen`` is
    ``vocab.advance_rows_seen``, both computed on the device with no sync.

    On the card it **updates ``state.first_pos`` and ``state.counts`` in
    place** (the reference donates them): thread the returned state
    through and do not read the old one.
    """
    rows, n_cols = modded.shape
    n_state, vocab_range = state.first_pos.shape
    if n_state != n_cols:
        raise ValueError(f"modded has {n_cols} columns, the state {n_state}")
    vocab_lib.check_row_ceiling(state.rows_seen, rows)
    pos = vocab_lib.positions(state.rows_seen, rows, valid)
    rows_seen = vocab_lib.advance_rows_seen(state.rows_seen, valid.to(torch.int32).sum())
    if modded.device.type == "cpu":
        vals_t = modded.t()
        counts = state.counts
        if counts is not None:
            counts = ref.genvocab_counts(counts, vals_t, pos)
        return vocab_lib.VocabState(ref.genvocab(state.first_pos, vals_t, pos), rows_seen, counts)
    dev = modded.device
    _build.check(modded, "modded", torch.int32)
    _build.check(valid, "valid", torch.bool, (rows,), dev)
    _build.check(state.first_pos, "first_pos", torch.int32, device=dev)
    if state.counts is not None:
        _build.check(state.counts, "counts", torch.int32, state.first_pos.shape, dev)
    _check_elements(rows, n_cols)
    if rows and n_cols:
        p = _build.ptr
        counts_ptr = p(state.counts) if state.counts is not None else None
        KERNEL_GENVOCAB.launch(
            dev, p(state.first_pos), counts_ptr, p(modded), p(pos), rows, n_cols, vocab_range
        )
    return vocab_lib.VocabState(state.first_pos, rows_seen, state.counts)


def apply_vocab(table: torch.Tensor, modded: torch.Tensor) -> torch.Tensor:
    """ApplyVocab-2: ``ids[r, c] = table[c, modded[r, c]]``.

    table int32 [n_cols, vocab_range]; modded int32 [rows, n_cols] in
    ``[0, vocab_range)`` (the pipeline's row-major layout) → ids int32
    [rows, n_cols].
    """
    rows, n_cols = modded.shape
    if table.shape[0] != n_cols:
        raise ValueError(f"table has {table.shape[0]} columns, modded {n_cols}")
    if modded.device.type == "cpu":
        return ref.apply_vocab(table, modded.t()).t().contiguous()
    dev = modded.device
    _build.check(modded, "modded", torch.int32)
    _build.check(table, "table", torch.int32, device=dev)
    _check_elements(rows, n_cols)
    ids = torch.empty((rows, n_cols), dtype=torch.int32, device=dev)
    if rows and n_cols:
        p = _build.ptr
        KERNEL_APPLY.launch(dev, p(table), p(modded), p(ids), rows, n_cols, int(table.shape[1]))
    return ids
