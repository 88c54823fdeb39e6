"""Two-loop columnar vocabulary engine (GenVocab / ApplyVocab).

Counterpart of ``repro/core/vocab.py``. Loop ① streams the dataset and
records, per sparse column, the **first-occurrence position** of every
modded value (a scatter-min, order-independent); ``finalize`` ranks those
positions into appearing-sequence ordinals; loop ② maps every feature
through the finalized table.

Position arithmetic and the stream-length ceiling
-------------------------------------------------
Row positions are int32 and ``NEVER = int32.max`` is reserved as the
absent sentinel, so a stream tops out at :data:`MAX_ROWS` (= 2³¹ − 1)
rows. :func:`positions` and :func:`advance_rows_seen` compute in uint32
(held in int64, see ``core/uint32.py``) and **saturate at NEVER**: rows
past the ceiling scatter the min identity instead of wrapping negative.

:func:`check_row_ceiling` raises ``OverflowError`` when ``rows_seen`` is
on the host. On a CUDA tensor it does nothing, since reading the count
would synchronise the stream: the engines keep their own no-sync upper
bound (``PiperPipeline.build_state_stream``) and the kernels saturate —
the counterpart of the reference's no-op under tracing.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.uint32 import MASK32, as_u32

# Sentinel for "value never seen". Must exceed any real position.
NEVER = 2**31 - 1
# Hard stream-length ceiling: at most NEVER rows carry representable positions.
MAX_ROWS = NEVER


def positions(rows_seen: torch.Tensor, rows: int, valid: torch.Tensor) -> torch.Tensor:
    """Global int32 positions for one chunk's rows, overflow-safe.

    ``u32(rows_seen) + arange(rows)`` in uint32, saturated at ``NEVER``;
    invalid (padding) rows get ``NEVER`` too.
    """
    r = torch.arange(rows, dtype=torch.int64, device=valid.device)
    pos = (as_u32(rows_seen) + r) & MASK32
    pos = torch.clamp(pos, max=NEVER).to(torch.int32)
    return torch.where(valid, pos, torch.full_like(pos, NEVER))


def advance_rows_seen(rows_seen: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """``rows_seen + n_new`` in uint32, saturated at ``NEVER`` (int32)."""
    total = (as_u32(rows_seen) + as_u32(n_new)) & MASK32
    return torch.clamp(total, max=NEVER).to(torch.int32)


def check_row_ceiling(rows_seen, rows: int) -> None:
    """Raise ``OverflowError`` if absorbing ``rows`` more rows would pass
    :data:`MAX_ROWS`. A host-side guard: a no-op for a CUDA tensor (see
    the module docstring)."""
    if isinstance(rows_seen, torch.Tensor) and rows_seen.device.type != "cpu":
        return
    seen = int(rows_seen)
    if seen + int(rows) > MAX_ROWS:
        raise OverflowError(
            f"loop ① would absorb {rows} rows at offset {seen}, past the "
            f"int32 position ceiling of {MAX_ROWS} total rows (positions "
            "are int32 with NEVER reserved as the absent sentinel); split "
            "the stream or re-key it before the ceiling"
        )


@dataclasses.dataclass
class VocabState:
    """Loop-1 accumulator: first-occurrence position per (column, value).

    ``counts`` is optional (``None`` = untracked): when present it carries
    per-(column, value) occurrence counts, the ingredient of
    :func:`finalize_topk` / :func:`finalize_min_count`.
    """

    first_pos: torch.Tensor  # int32 [n_columns, vocab_range], NEVER = absent
    rows_seen: torch.Tensor  # int32 [] — global row counter (stream offset)
    counts: torch.Tensor | None = None  # int32 [n_columns, vocab_range] | None

    @classmethod
    def init(
        cls,
        n_columns: int,
        vocab_range: int,
        track_counts: bool = False,
        *,
        device="cuda",
    ) -> "VocabState":
        return cls(
            first_pos=torch.full(
                (n_columns, vocab_range), NEVER, dtype=torch.int32, device=device
            ),
            rows_seen=torch.zeros((), dtype=torch.int32, device=device),
            counts=(
                torch.zeros((n_columns, vocab_range), dtype=torch.int32, device=device)
                if track_counts
                else None
            ),
        )


def check_compatible(a: VocabState, b: VocabState) -> None:
    """Raise a clear ``ValueError`` unless ``a`` and ``b`` can merge."""
    if a.first_pos.shape != b.first_pos.shape:
        raise ValueError(
            "cannot merge VocabStates with different vocab layouts: "
            f"first_pos {tuple(a.first_pos.shape)} vs "
            f"{tuple(b.first_pos.shape)} — loop ① states merge only when "
            "built with the same (n_columns, vocab_range)"
        )
    if a.first_pos.dtype != b.first_pos.dtype:
        raise ValueError(
            "cannot merge VocabStates with different first_pos dtypes: "
            f"{a.first_pos.dtype} vs {b.first_pos.dtype}"
        )
    if (a.counts is None) != (b.counts is None):
        raise ValueError(
            "cannot merge a count-tracking VocabState with an untracked "
            "one — build every loop ① shard with the same track_counts "
            "setting (PipelineConfig.track_vocab_counts)"
        )


def update(state: VocabState, modded: torch.Tensor, valid: torch.Tensor) -> VocabState:
    """Absorb one chunk (loop-1 step); returns a new state.

    modded: int32 [rows, n_columns] already in [0, vocab_range)
    valid:  bool  [rows]

    Tracked counts increment for every valid row below the ceiling; rows
    dropped by saturation are dropped from the counts too.
    """
    rows = modded.shape[0]
    check_row_ceiling(state.rows_seen, rows)
    pos = positions(state.rows_seen, rows, valid)
    idx = modded.t().to(torch.int64)  # [n_columns, rows]
    src = pos[None, :].expand_as(idx)
    first_pos = state.first_pos.scatter_reduce(1, idx, src, reduce="amin")
    counts = state.counts
    if counts is not None:
        inc = (pos < NEVER).to(torch.int32)  # valid AND below the ceiling
        counts = counts.scatter_add(1, idx, inc[None, :].expand_as(idx))
    rows_seen = advance_rows_seen(state.rows_seen, valid.to(torch.int32).sum())
    return VocabState(first_pos=first_pos, rows_seen=rows_seen, counts=counts)


def merge(a: VocabState, b: VocabState) -> VocabState:
    """Merge loop-1 states from disjoint row shards: elementwise ``min`` on
    positions, saturating ``+`` on row counts, ``+`` on tracked counts — a
    commutative monoid whose identity is ``VocabState.init``. States with
    a leading stack axis merge elementwise too (:func:`merge_tree`)."""
    check_compatible(a, b)
    return VocabState(
        first_pos=torch.minimum(a.first_pos, b.first_pos),
        rows_seen=advance_rows_seen(a.rows_seen, b.rows_seen),
        counts=None if a.counts is None else a.counts + b.counts,
    )


def _map_state(fn, s: VocabState) -> VocabState:
    return VocabState(
        first_pos=fn(s.first_pos),
        rows_seen=fn(s.rows_seen),
        counts=None if s.counts is None else fn(s.counts),
    )


def merge_tree(states: VocabState) -> VocabState:
    """Tree-reduce a stack of per-shard loop-1 states (leading shard axis
    on every field) into one state, as a log2-depth halving tree. The
    stack is padded to a power of two with the monoid identity."""
    n = int(states.first_pos.shape[0])
    pow2 = 1 << max(n - 1, 0).bit_length()  # next power of two ≥ n
    if pow2 != n:
        pad = pow2 - n
        fp = states.first_pos
        states = VocabState(
            first_pos=torch.cat(
                [fp, torch.full((pad,) + fp.shape[1:], NEVER, dtype=torch.int32, device=fp.device)]
            ),
            rows_seen=torch.cat(
                [states.rows_seen, torch.zeros(pad, dtype=torch.int32, device=fp.device)]
            ),
            counts=(
                None
                if states.counts is None
                else torch.cat(
                    [
                        states.counts,
                        torch.zeros(
                            (pad,) + states.counts.shape[1:], dtype=torch.int32, device=fp.device
                        ),
                    ]
                )
            ),
        )
    while pow2 > 1:
        half = pow2 // 2
        states = merge(
            _map_state(lambda x: x[:half], states),
            _map_state(lambda x: x[half:], states),
        )
        pow2 = half
    return _map_state(lambda x: x[0], states)


@dataclasses.dataclass
class Vocabulary:
    """Finalized tables: value → appearing-sequence ordinal.

    From :func:`finalize` every present value gets a dense ordinal in
    ``[0, sizes[c])`` and absent values map to 0. From the frequency-
    capped finalizers every kept value gets a dense ordinal and every
    other value maps to the explicit OOV ordinal ``sizes[c]``.
    """

    table: torch.Tensor   # int32 [n_columns, vocab_range]
    sizes: torch.Tensor   # int32 [n_columns] — number of present/kept values

    @property
    def vocab_range(self) -> int:
        return int(self.table.shape[1])

    @property
    def oov_ordinals(self) -> torch.Tensor:
        """Per-column OOV ordinal of the capped finalizers (== sizes)."""
        return self.sizes


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """Rank of each entry of every row of ``key``: a stable double argsort."""
    order = torch.argsort(key, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def finalize(state: VocabState) -> Vocabulary:
    present = state.first_pos < NEVER
    ranks = _ranks(state.first_pos)
    table = torch.where(present, ranks, 0).to(torch.int32)
    sizes = present.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return Vocabulary(table=table, sizes=sizes)


def _capped_table(first_pos: torch.Tensor, kept: torch.Tensor) -> Vocabulary:
    """Kept values rank by first occurrence; everything else maps to the
    per-column OOV ordinal ``sizes[c]``."""
    key = torch.where(kept, first_pos, NEVER)
    ranks = _ranks(key)
    sizes = kept.to(torch.int32).sum(dim=1, dtype=torch.int32)
    table = torch.where(kept, ranks, sizes[:, None].to(torch.int64)).to(torch.int32)
    return Vocabulary(table=table, sizes=sizes)


def _require_counts(state: VocabState) -> torch.Tensor:
    if state.counts is None:
        raise ValueError(
            "frequency-capped finalize needs a count-tracking VocabState — "
            "build loop ① with VocabState.init(..., track_counts=True) "
            "(PipelineConfig.track_vocab_counts=True)"
        )
    return state.counts


def finalize_topk(state: VocabState, k: int) -> Vocabulary:
    """Keep each column's ``k`` most frequent values, ties broken by earlier
    first occurrence; others map to the OOV ordinal ``sizes[c]``.

    The reference's ``lexsort((pos_key, neg_count))`` becomes two stable
    sorts: by the secondary key first, then by the primary key.
    """
    counts = _require_counts(state)
    if k < 0:
        raise ValueError(f"finalize_topk needs k >= 0, got {k}")
    first_pos = state.first_pos
    present = first_pos < NEVER
    neg_count = torch.where(present, -counts, 1)
    pos_key = torch.where(present, first_pos, NEVER)
    by_pos = torch.argsort(pos_key, dim=1, stable=True)
    by_count = torch.argsort(torch.gather(neg_count, 1, by_pos), dim=1, stable=True)
    order = torch.gather(by_pos, 1, by_count)
    rank = torch.argsort(order, dim=1, stable=True)
    kept = present & (rank < int(k))
    return _capped_table(first_pos, kept)


def finalize_min_count(state: VocabState, min_count: int) -> Vocabulary:
    """Keep values seen at least ``min_count`` times; everything else maps
    to the OOV ordinal ``sizes[c]``."""
    counts = _require_counts(state)
    if min_count < 1:
        raise ValueError(f"finalize_min_count needs min_count >= 1, got {min_count}")
    kept = (state.first_pos < NEVER) & (counts >= int(min_count))
    return _capped_table(state.first_pos, kept)


def lookup(vocab: Vocabulary, modded: torch.Tensor) -> torch.Tensor:
    """Loop-2 mapping (ApplyVocab-2): ``ids[r, c] = table[c, modded[r, c]]``.

    modded: int32 [rows, n_columns] → int32 [rows, n_columns].
    """
    return torch.gather(vocab.table, 1, modded.t().to(torch.int64)).t().contiguous()
