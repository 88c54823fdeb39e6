"""The PIPER two-loop preprocessing pipeline (paper Figure 5).

Counterpart of ``repro/core/pipeline.py``. Loop ① streams the dataset once
and accumulates the per-column :class:`vocab.VocabState`; loop ② re-streams
it and emits the final table. Between chunks the only carried state is the
``VocabState``, so datasets far larger than device memory stream through.

Two execution styles, as in the reference:
  * ``*_stream`` — a Python iterator of chunks feeds the per-chunk step;
  * ``*_scan``   — all chunks stacked on a leading axis, moved to the
    device once and looped over (the reference's ``lax.scan``).

The per-chunk chain is the reference's default plan (``plan.criteo_default``):
Decode(+FillMissing) → [sparse: Modulus → GenVocab → ApplyVocab] ∥
[dense: Neg2Zero → Logarithm], run directly as the compiled plan's
``vocab_step`` and ``transform`` run it for that plan. The plan IR and its
compiler are not ported yet (ROADMAP queue 1 item 3).

On ``device="cuda"`` decode runs the decode kernel, and the fused hints
(None) resolve to the loop-① and loop-② kernels; ``False`` selects the
unfused operator chain, the differential oracle. With
``use_fused_decode=True`` a utf8 feed takes the bytes-in route instead:
each loop is one kernel launch from raw bytes, and the decoded field
table is never stored. On ``device="cpu"`` every stage runs its plain
PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core import ops
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels.decode_utf8 import ops as decode_ops

# Config fields of the reference that this slice keeps only at their
# defaults: field → (default, where the ROADMAP lists the work).
_NOT_PORTED = {
    "use_kernels": (False, "the unfused per-op kernels, ROADMAP queue 2 items 8-10 (slice 3)"),
    "vocab_slab_range": (None, "the plan compiler's route metadata, ROADMAP queue 1 item 3"),
    "plan": (None, "the plan IR and its compiler, ROADMAP queue 1 item 3"),
}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    schema: schema_lib.TableSchema = schema_lib.CRITEO
    chunk_bytes: int = 1 << 20
    # Static per-chunk row capacity; unclaimed rows carry valid=False.
    max_rows_per_chunk: int = 1 << 14
    # Input already decoded ("binary", the paper's Config III) or raw UTF-8.
    input_format: str = "utf8"
    use_kernels: bool = False
    # Loop ② as one fused kernel launch per chunk (kernels/fused_xform).
    # None → on for device "cuda", the plain chain on "cpu"; False → the
    # unfused operator chain; True on "cpu" raises.
    use_fused_kernel: bool | None = None
    # Loop ① as one fused kernel launch per chunk (kernels/fused_vocab),
    # same resolution as use_fused_kernel. The state is bit-identical
    # either way.
    use_fused_vocab: bool | None = None
    # Each loop straight from raw UTF-8 bytes, decode included, as one
    # kernel launch per chunk (kernels/fused_decode_vocab, _xform); utf8
    # feeds only. None → off, as in the reference; True opts in. Unlike the
    # two hints above, True on "cpu" is allowed and runs the route with the
    # plain versions, as the reference's own tests run it on the CPU, so the
    # routing is tested off the card. Loop ① stays on decode + the loop-①
    # kernel when track_vocab_counts is on (the bytes-in kernel carries no
    # count plane); loop ② needs a dense and a sparse column.
    use_fused_decode: bool | None = None
    # Carry the occurrence-count plane beside first_pos (VocabState.counts),
    # needed by vocab.finalize_topk / finalize_min_count.
    track_vocab_counts: bool = False
    vocab_slab_range: int | None = None
    plan: object = None
    # Where the pipeline runs. "cuda" raises when there is no card.
    device: str = "cuda"

    def __post_init__(self):
        if self.input_format not in ("utf8", "binary"):
            raise ValueError(f"unknown input_format: {self.input_format}")
        for field, (default, item) in _NOT_PORTED.items():
            if getattr(self, field) is not default:
                raise NotImplementedError(
                    f"PipelineConfig.{field}={getattr(self, field)!r} is not ported "
                    f"yet ({item}); leave it at {default!r}"
                )
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PipelineConfig(device='cuda') but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch chain on the CPU"
            )
        for hint in ("use_fused_kernel", "use_fused_vocab"):
            if getattr(self, hint) is True and dev.type == "cpu":
                raise ValueError(
                    f"{hint}=True needs device='cuda': the fused kernels are CUDA "
                    "kernels, and the CPU runs the plain chain"
                )

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    @property
    def fused_enabled(self) -> bool:
        """The resolved ``use_fused_kernel`` hint (None → on for CUDA)."""
        if self.use_fused_kernel is None:
            return self.torch_device.type == "cuda"
        return self.use_fused_kernel

    @property
    def fused_vocab_enabled(self) -> bool:
        """The resolved ``use_fused_vocab`` hint (None → on for CUDA)."""
        if self.use_fused_vocab is None:
            return self.torch_device.type == "cuda"
        return self.use_fused_vocab

    @property
    def fused_decode_enabled(self) -> bool:
        """The resolved ``use_fused_decode`` hint (None → off)."""
        return bool(self.use_fused_decode)


class PiperPipeline:
    """Two-loop columnar preprocessing engine."""

    def __init__(self, config: PipelineConfig):
        self.config = config
        self.schema = config.schema
        self.device = config.torch_device
        self._hex_table = self.schema.field_is_hex()  # host-side: no sync per chunk
        self._fused = config.fused_enabled
        self._fused_vocab = config.fused_vocab_enabled
        # Bytes-in routing, static per engine (the reference's admissibility
        # rules for its default plan): a utf8 feed with the hint on, a sparse
        # column, and for loop ① no count plane, for loop ② a dense column.
        bytes_in = (
            config.input_format == "utf8"
            and config.fused_decode_enabled
            and self.schema.n_sparse > 0
        )
        self._bytes_vocab = bytes_in and not config.track_vocab_counts
        self._bytes_xform = bytes_in and self.schema.n_dense > 0
        self._bytes_kw = dict(
            n_fields=self.schema.n_fields,
            n_dense=self.schema.n_dense,
            n_sparse=self.schema.n_sparse,
            max_rows=config.max_rows_per_chunk,
        )

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    # ------------------------------------------------------------------ #
    # Decode stage
    # ------------------------------------------------------------------ #
    def decode_chunk(self, chunk) -> schema_lib.TabularBatch:
        """Decode one padded UTF-8 chunk (whole rows) into a TabularBatch."""
        label, dense, sparse, valid = decode_ops.decode(
            self._tensor(chunk),
            self._hex_table,
            n_fields=self.schema.n_fields,
            max_rows=self.config.max_rows_per_chunk,
            n_dense=self.schema.n_dense,
            n_sparse=self.schema.n_sparse,
        )
        return schema_lib.TabularBatch(label=label, dense=dense, sparse=sparse, valid=valid)

    def _as_batch(self, chunk) -> schema_lib.TabularBatch:
        """Normalize an input chunk (utf8 bytes or binary dict) to a batch."""
        if self.config.input_format == "utf8":
            return self.decode_chunk(chunk)
        label = self._tensor(chunk["label"])
        valid = chunk.get("valid")
        if valid is None:
            valid = torch.ones(label.shape[0], dtype=torch.bool, device=self.device)
        return schema_lib.TabularBatch(
            label=label,
            dense=self._tensor(chunk["dense"]),
            sparse=self._tensor(chunk["sparse"]),
            valid=self._tensor(valid),
        )

    def _chunk_rows(self, chunk) -> int:
        """Row capacity of one chunk, known on the host without a sync."""
        if self.config.input_format == "utf8":
            return self.config.max_rows_per_chunk
        return int(chunk["label"].shape[0])

    def _unstack(self, stacked) -> Iterator:
        """Chunks of a stacked feed (leading chunk axis), moved to the device
        in one copy."""
        if self.config.input_format == "utf8":
            chunks = self._tensor(stacked)
            for i in range(chunks.shape[0]):
                yield chunks[i]
            return
        chunks = {k: self._tensor(v) for k, v in stacked.items()}
        for i in range(chunks["label"].shape[0]):
            yield {k: v[i] for k, v in chunks.items()}

    # ------------------------------------------------------------------ #
    # Loop ① — GenVocab
    # ------------------------------------------------------------------ #
    def init_state(self) -> vocab_lib.VocabState:
        return vocab_lib.VocabState.init(
            self.schema.n_sparse,
            self.schema.vocab_range,
            track_counts=self.config.track_vocab_counts,
            device=self.device,
        )

    def vocab_step(self, state: vocab_lib.VocabState, chunk) -> vocab_lib.VocabState:
        """Absorb one chunk: every sparse column's uint32 Modulus →
        GenVocab scatter-min, as one kernel launch when the hint is on —
        decode included on the bytes-in route. The fused kernels update
        ``state`` in place."""
        if self._bytes_vocab:
            return ops.fused_decode_vocab_update(state, self._tensor(chunk), **self._bytes_kw)
        batch = self._as_batch(chunk)
        return ops.fused_vocab_update(
            state, batch.sparse, batch.valid, use_kernel=self._fused_vocab
        )

    def build_state_stream(self, chunks: Iterable) -> vocab_lib.VocabState:
        """Loop ① over a host iterator, stopping *before* finalization."""
        state = self.init_state()
        # Host-side stream-length guard: positions are int32, so a stream
        # may carry at most vocab.MAX_ROWS rows (beyond that the kernels
        # saturate and drop rows). Track a no-sync upper bound (reading
        # rows_seen off the card would sync); only when the bound would
        # cross the ceiling, read the true count and fail loudly if the
        # next chunk could overflow.
        rows_ub = 0
        for chunk in chunks:
            cap = self._chunk_rows(chunk)
            rows_ub += cap
            if rows_ub > vocab_lib.MAX_ROWS:
                seen = int(state.rows_seen)
                if seen + cap > vocab_lib.MAX_ROWS:
                    raise OverflowError(
                        f"loop ① stream exceeds the int32 position ceiling: "
                        f"{seen} rows seen + up to {cap} more > "
                        f"{vocab_lib.MAX_ROWS}"
                    )
                rows_ub = seen + cap
            state = self.vocab_step(state, chunk)
        return state

    def build_vocab_stream(self, chunks: Iterable) -> vocab_lib.Vocabulary:
        """Loop ① over a host iterator (out-of-core / network path)."""
        return vocab_lib.finalize(self.build_state_stream(chunks))

    def build_vocab_scan(self, stacked_chunks) -> vocab_lib.Vocabulary:
        """Loop ① over chunks stacked on a leading axis."""
        state = self.init_state()
        for chunk in self._unstack(stacked_chunks):
            state = self.vocab_step(state, chunk)
        return vocab_lib.finalize(state)

    # ------------------------------------------------------------------ #
    # Loop ② — ApplyVocab + dense transforms
    # ------------------------------------------------------------------ #
    def transform_chunk(
        self, vocabulary: vocab_lib.Vocabulary, chunk
    ) -> schema_lib.ProcessedBatch:
        """Modulus → ApplyVocab ∥ Neg2Zero → Logarithm on one chunk, as one
        kernel launch when the hint is on — decode included on the bytes-in
        route."""
        if self._bytes_xform:
            label, dense, ids, valid = ops.fused_decode_transform(
                vocabulary, self._tensor(chunk), **self._bytes_kw
            )
            return schema_lib.ProcessedBatch(label=label, dense=dense, sparse=ids, valid=valid)
        batch = self._as_batch(chunk)
        ids, dense = ops.fused_transform(
            vocabulary, batch.sparse, batch.dense, use_kernel=self._fused
        )
        return schema_lib.ProcessedBatch(
            label=batch.label, dense=dense, sparse=ids, valid=batch.valid
        )

    def frozen_transform(self, vocabulary: vocab_lib.Vocabulary) -> "FrozenVocabTransform":
        """Loop ② as a standalone serving-mode step (see the class)."""
        return FrozenVocabTransform(vocabulary, pipeline=self)

    def transform_stream(
        self, vocabulary: vocab_lib.Vocabulary, chunks: Iterable
    ) -> Iterator[schema_lib.ProcessedBatch]:
        step = self.frozen_transform(vocabulary)
        for chunk in chunks:
            yield step(chunk)

    def transform_scan(
        self, vocabulary: vocab_lib.Vocabulary, stacked_chunks
    ) -> schema_lib.ProcessedBatch:
        """Loop ② over stacked chunks → [n_chunks, rows, ...] outputs
        (callers flatten if they need one table)."""
        outs = [self.transform_chunk(vocabulary, c) for c in self._unstack(stacked_chunks)]
        return schema_lib.ProcessedBatch(
            **{
                f.name: torch.stack([getattr(o, f.name) for o in outs])
                for f in dataclasses.fields(schema_lib.ProcessedBatch)
            }
        )

    # ------------------------------------------------------------------ #
    # End-to-end (both loops)
    # ------------------------------------------------------------------ #
    def run_stream(self, chunk_factory) -> Iterator[schema_lib.ProcessedBatch]:
        """Full two-loop run. ``chunk_factory()`` must return a fresh
        iterator each call (the dataset is streamed twice)."""
        vocabulary = self.build_vocab_stream(chunk_factory())
        yield from self.transform_stream(vocabulary, chunk_factory())

    def run_scan(self, stacked_chunks) -> schema_lib.ProcessedBatch:
        vocabulary = self.build_vocab_scan(stacked_chunks)
        return self.transform_scan(vocabulary, stacked_chunks)


class FrozenVocabTransform:
    """Loop ② factored out of the two-loop engine: frozen-vocab serving.

    Wraps a finalized :class:`vocab.Vocabulary` plus the per-chunk chain
    (Decode → Modulus → ApplyVocab ∥ Neg2Zero → Logarithm; one bytes-in
    launch per request when ``use_fused_decode`` is on) behind one
    callable, so a request stream of any length is served with bounded
    state. The vocabulary can be swapped between calls.
    """

    def __init__(
        self,
        vocabulary: vocab_lib.Vocabulary,
        config: PipelineConfig | None = None,
        pipeline: PiperPipeline | None = None,
    ):
        if pipeline is None:
            if config is None:
                raise ValueError("need a PipelineConfig or a PiperPipeline")
            pipeline = PiperPipeline(config)
        self._pipe = pipeline
        self._vocab = vocabulary

    @property
    def config(self) -> PipelineConfig:
        return self._pipe.config

    @property
    def vocabulary(self) -> vocab_lib.Vocabulary:
        return self._vocab

    def swap_vocabulary(self, vocabulary: vocab_lib.Vocabulary) -> None:
        """Replace the frozen vocabulary; callers serialize swaps against
        :meth:`__call__`."""
        self._vocab = vocabulary

    def __call__(self, chunk) -> schema_lib.ProcessedBatch:
        return self._pipe.transform_chunk(self._vocab, chunk)


def flatten_processed(out: schema_lib.ProcessedBatch) -> schema_lib.ProcessedBatch:
    """[n_chunks, rows, ...] → [n_chunks*rows, ...] (keeps padding rows)."""
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    return schema_lib.ProcessedBatch(
        label=flat(out.label),
        dense=flat(out.dense),
        sparse=flat(out.sparse),
        valid=flat(out.valid),
    )
