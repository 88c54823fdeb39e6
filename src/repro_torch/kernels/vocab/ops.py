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

On the card ``genvocab_update`` is that one launch and no other device
work: the kernel computes the positions from ``rows_seen`` itself and
counts the valid rows into the row tally it shares with
``fused_vocab`` (``_scratch.tally``, one per (device, stream)),
writing the advanced ``rows_seen`` to a new tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _build
from repro_torch.kernels._scratch import tally
from repro_torch.kernels.fused_vocab import ops as fv_ops
from repro_torch.kernels.vocab import ref

_P, _I = _build.PTR, _build.INT
KERNEL_GENVOCAB = _build.Kernel("vocab", "genvocab", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I])
KERNEL_APPLY = _build.Kernel("vocab", "apply_vocab", [_P, _P, _P, _I, _I, _I])
LAUNCH_ENTRIES = {"genvocab": 0, "apply_vocab": 1}  # C symbol → entry of vocab_launch_config
APPLY_THREADS = 128  # csrc/vocab.cu kApplyThreads


def launch_accounting(symbol: str, rows: int, n_cols: int, *, wave: int | None = None
                      ) -> list[dict]:
    """The launches of ``symbol`` over ``rows`` x ``n_cols`` values, as
    ``vocab_launch_config`` reports them: ``genvocab`` is
    ``genvocab_warp_kernel``'s launch; ``apply_vocab`` is a block of 128
    threads per 128 quads of an aligned output, at most ``wave`` blocks (the
    card's resident wave of the kernel; None: uncapped)."""
    if symbol == "genvocab":
        return fv_ops.genvocab_warp_launch(rows, n_cols)
    if symbol != "apply_vocab":
        raise ValueError(f"vocab has no entry point {symbol!r}")
    want = max(1, -(-(rows * n_cols // 4) // APPLY_THREADS))
    return [_build.launch_record("apply_vocab_kernel", (want if wave is None else min(want, wave),),
                                 APPLY_THREADS, cap=wave or 0)]


def _check_elements(rows: int, n_cols: int) -> None:
    if rows * n_cols >= 2**31:
        raise ValueError(f"{rows} x {n_cols} elements; the kernel takes fewer than 2**31")


@_build.entry(KERNEL_GENVOCAB)
def genvocab_update(
    state: vocab_lib.VocabState, modded: torch.Tensor, valid: torch.Tensor
) -> vocab_lib.VocabState:
    """Absorb one chunk of modded values into the first-occurrence state.

    modded int32 [rows, n_cols] in ``[0, vocab_range)``; valid bool [rows]
    → the updated state, bit-identical to ``vocab.update``: positions are
    ``vocab.positions`` and the new ``rows_seen`` is
    ``vocab.advance_rows_seen``.

    On the card it **updates ``state.first_pos`` and ``state.counts`` in
    place** (the reference donates them): thread the returned state
    through and do not read the old one.
    """
    rows, n_cols = modded.shape
    n_state, vocab_range = state.first_pos.shape
    if n_state != n_cols:
        raise ValueError(f"modded has {n_cols} columns, the state {n_state}")
    vocab_lib.check_row_ceiling(state.rows_seen, rows)
    if modded.device.type == "cpu":
        pos = vocab_lib.positions(state.rows_seen, rows, valid)
        rows_seen = vocab_lib.advance_rows_seen(state.rows_seen, valid.to(torch.int32).sum())
        vals_t = modded.t()
        counts = state.counts
        if counts is not None:
            counts = ref.genvocab_counts(counts, vals_t, pos)
        return vocab_lib.VocabState(ref.genvocab(state.first_pos, vals_t, pos), rows_seen, counts)
    if rows == 0:
        return state
    dev = modded.device
    _build.check(modded, "modded", torch.int32)
    _build.check(valid, "valid", torch.bool, (rows,), dev)
    _build.check(state.first_pos, "first_pos", torch.int32, device=dev)
    _build.check(state.rows_seen, "rows_seen", torch.int32, (), dev)
    if state.counts is not None:
        _build.check(state.counts, "counts", torch.int32, state.first_pos.shape, dev)
    _check_elements(rows, n_cols)
    rows_seen = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    counts_ptr = p(state.counts) if state.counts is not None else None
    KERNEL_GENVOCAB.launch(
        dev, p(state.first_pos), counts_ptr, p(modded), p(valid), p(state.rows_seen),
        p(rows_seen), p(tally(dev, torch.cuda.current_stream(dev).cuda_stream)), rows, n_cols,
        vocab_range,
    )
    return vocab_lib.VocabState(state.first_pos, rows_seen, state.counts)


@_build.entry(KERNEL_APPLY)
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
