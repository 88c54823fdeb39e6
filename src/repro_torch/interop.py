"""Carry the pipeline's learned parameters and its plan between packages.

The system has no model weights: what loop ① learns is the
:class:`~repro_torch.core.vocab.VocabState` (first positions, row count
and the optional count plane) and what loop ② serves is the finalized
:class:`~repro_torch.core.vocab.Vocabulary`. These functions move both to
and from numpy, so a state that the JAX package's loop ① built continues
in the port's, and the reverse. :func:`plan_from_reference` turns the JAX
package's preprocessing plan into the port's, so both compile one plan.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import vocab as vocab_lib


def _int32(x, name: str, ndim: int, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != np.int32:
        raise TypeError(f"{name}: expected int32, got {arr.dtype}")
    if arr.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {arr.shape}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def vocab_state_from_numpy(
    first_pos, rows_seen, counts=None, *, device
) -> vocab_lib.VocabState:
    """int32 ``first_pos [n_columns, vocab_range]``, int32 scalar
    ``rows_seen`` and optional int32 ``counts`` → a state on ``device``."""
    fp = _int32(first_pos, "first_pos", 2, device)
    cnt = None
    if counts is not None:
        cnt = _int32(counts, "counts", 2, device)
        if cnt.shape != fp.shape:
            raise ValueError(f"counts {tuple(cnt.shape)} vs first_pos {tuple(fp.shape)}")
    return vocab_lib.VocabState(
        first_pos=fp, rows_seen=_int32(rows_seen, "rows_seen", 0, device), counts=cnt
    )


def vocab_state_to_numpy(state: vocab_lib.VocabState):
    """→ ``(first_pos, rows_seen, counts | None)`` as int32 numpy arrays."""
    counts = None if state.counts is None else state.counts.cpu().numpy()
    return state.first_pos.cpu().numpy(), state.rows_seen.cpu().numpy(), counts


def vocabulary_from_numpy(table, sizes, *, device) -> vocab_lib.Vocabulary:
    """int32 ``table [n_columns, vocab_range]`` and ``sizes [n_columns]``
    → a vocabulary on ``device``."""
    return vocab_lib.Vocabulary(
        table=_int32(table, "table", 2, device), sizes=_int32(sizes, "sizes", 1, device)
    )


def vocabulary_to_numpy(vocab: vocab_lib.Vocabulary):
    """→ ``(table, sizes)`` as int32 numpy arrays."""
    return vocab.table.cpu().numpy(), vocab.sizes.cpu().numpy()


def plan_from_reference(plan) -> plan_lib.PreprocPlan:
    """A ``PreprocPlan`` of the JAX package → the port's, field by field.

    Reads only attributes (``columns``; each column's ``kind``, ``source``,
    ``ops`` and ``name``; each op's ``name`` and ``params``), so it needs
    nothing of the JAX package and takes any object of that shape."""
    return plan_lib.PreprocPlan(
        columns=tuple(
            plan_lib.ColumnSpec(
                kind=c.kind,
                source=tuple(c.source) if isinstance(c.source, tuple) else c.source,
                ops=tuple(plan_lib.OpSpec(name=o.name, params=tuple(o.params)) for o in c.ops),
                name=c.name,
            )
            for c in plan.columns
        )
    )
