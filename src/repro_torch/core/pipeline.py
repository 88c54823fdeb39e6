"""The PIPER two-loop preprocessing pipeline (paper Figure 5).

Counterpart of ``repro/core/pipeline.py``. Loop ① streams the dataset once
and accumulates the per-column :class:`vocab.VocabState`; loop ② re-streams
it and emits the final table. Between chunks the only carried state is the
``VocabState``, so datasets far larger than device memory stream through.

Two execution styles, as in the reference:
  * ``*_stream`` — a Python iterator of chunks feeds the per-chunk step;
  * ``*_scan``   — all chunks stacked on a leading axis, moved to the
    device once and looped over (the reference's ``lax.scan``).

The per-chunk operator chain is **plan-driven**: ``PipelineConfig.plan``
holds a declarative :class:`~repro_torch.core.plan.PreprocPlan` (default:
``plan.criteo_default`` — Decode(+FillMissing) → [sparse: Modulus →
GenVocab → ApplyVocab] ∥ [dense: Neg2Zero → Logarithm]), which
``plan_compiler.compile_plan`` validates, groups and routes once per
engine. The engine only ever runs the compiled plan's two halves,
``vocab_step`` (loop ①) and ``transform`` (loop ②), so crossed features,
bucketized dense columns and other schemas run through the same code.

On ``device="cuda"`` decode runs the decode kernel, and the fused hints
(None) resolve to the loop-① and loop-② kernels; ``False`` selects the
unfused operator chain, which ``use_kernels=True`` runs through the
per-op kernels (GenVocab, ApplyVocab, the dense transform) and which is
otherwise plain PyTorch, the differential oracle. With
``use_fused_decode=True`` a utf8 feed takes the bytes-in route instead,
where the plan allows it: each loop is one kernel launch from raw bytes,
and the decoded field table is never stored. On ``device="cpu"`` every
stage runs its plain PyTorch version.

Instrumentation (``repro_torch.obs``), as in the reference: while the
process tracer is on (``obs.enable()``), each chunk runs inside a
``loop1/chunk`` or ``loop2/chunk`` span labelled with the engine and the
compiled route, and ``obs.set_stage_spans(True)`` nests ``decode`` and
``vocab_update`` / ``transform`` spans inside the chunk spans of the
decoded utf8 route. Spans time host blocks: they launch nothing and
synchronise nothing. The process registry counts chunks, rows and bytes
per loop (``pipeline.loop{1,2}_{chunks,rows,bytes}_total``), added once
a loop call (once a call of a :class:`FrozenVocabTransform`). The loops
are host-bound, so with the tracer off a chunk pays for neither. The
rows of a utf8 chunk are counted from its newlines only with stage spans
on: the count is a host pass over every byte, which costs more than the
rest of a chunk's host work in the loops.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import plan as plan_lib
from repro_torch.core import plan_compiler
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels.decode_utf8 import ops as decode_ops

@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    schema: schema_lib.TableSchema = schema_lib.CRITEO
    chunk_bytes: int = 1 << 20
    # Static per-chunk row capacity; unclaimed rows carry valid=False.
    max_rows_per_chunk: int = 1 << 14
    # Input already decoded ("binary", the paper's Config III) or raw UTF-8.
    input_format: str = "utf8"
    # Run the unfused chain's GenVocab, ApplyVocab and Neg2Zero → Logarithm
    # through their per-op kernels (kernels/vocab, kernels/dense_xform); the
    # fused hints below take precedence where they apply. On "cpu" the
    # wrappers take their plain versions, so the routing is tested there.
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
    # routing is tested off the card. It applies only where the plan is the
    # identity over the wire layout (CompiledPlan.decode_*_dispatch); loop ①
    # stays on decode + the loop-① kernel when track_vocab_counts is on (the
    # bytes-in kernel carries no count plane).
    use_fused_decode: bool | None = None
    # Carry the occurrence-count plane beside first_pos (VocabState.counts),
    # needed by vocab.finalize_topk / finalize_min_count.
    track_vocab_counts: bool = False
    # The reference's forced loop-① slab width; not ported, must stay None.
    vocab_slab_range: int | None = None
    # The declarative per-column program (core/plan.py). None =
    # plan.criteo_default(schema), the paper's chain. Compiled once per
    # engine by plan_compiler.compile_plan.
    plan: plan_lib.PreprocPlan | None = None
    # Where the pipeline runs. "cuda" raises when there is no card.
    device: str = "cuda"

    def __post_init__(self):
        if self.input_format not in ("utf8", "binary"):
            raise ValueError(f"unknown input_format: {self.input_format}")
        if self.vocab_slab_range is not None:
            raise NotImplementedError(
                f"PipelineConfig.vocab_slab_range={self.vocab_slab_range!r} is not "
                "ported: it forces the reference's hbm_slab tier, and the port's "
                "loop-① kernels have one device-memory route at every vocab range "
                "(ROADMAP); leave it at None"
            )
        if self.plan is not None and not isinstance(self.plan, plan_lib.PreprocPlan):
            raise TypeError(
                "PipelineConfig.plan must be a repro_torch.core.plan.PreprocPlan "
                f"or None (criteo_default), got {type(self.plan).__name__}; a plan "
                "of the JAX package converts with interop.plan_from_reference"
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

    def resolved_plan(self) -> plan_lib.PreprocPlan:
        """The plan this config executes (None → the Criteo default)."""
        return self.plan if self.plan is not None else plan_lib.criteo_default(self.schema)


class PiperPipeline:
    """Two-loop columnar preprocessing engine (executes a CompiledPlan)."""

    def __init__(self, config: PipelineConfig):
        self.config = config
        self.schema = config.schema
        self.device = config.torch_device
        self.plan = config.resolved_plan()
        # Compiled once per engine; both loops only ever run its two halves.
        self.compiled = plan_compiler.compile_plan(
            self.plan,
            self.schema,
            device=self.device,
            fused=config.fused_enabled,
            use_kernels=config.use_kernels,
            fused_vocab=config.fused_vocab_enabled,
            fused_decode=config.fused_decode_enabled,
            track_counts=config.track_vocab_counts,
        )
        # Bytes-in routing is static per engine: a utf8 feed, the hint on,
        # and a plan that is the identity over the wire layout (the
        # compiler's admissibility rules).
        self._bytes_vocab = (
            config.input_format == "utf8" and self.compiled.decode_vocab_dispatch
        )
        self._bytes_xform = (
            config.input_format == "utf8" and self.compiled.decode_xform_dispatch
        )
        self._hex_table = self.schema.field_is_hex()  # host-side: no sync per chunk
        # Span labels: the compiled plan's routes, stamped on every
        # per-chunk span so the trace says which code path the time went to.
        self._vocab_span_labels = {
            "engine": "piper",
            "route": (
                self.compiled.decode_vocab_route
                if self._bytes_vocab
                else self.compiled.vocab_route
            ),
        }
        self._xform_span_labels = {
            "engine": "piper",
            "route": (
                self.compiled.decode_xform_route
                if self._bytes_xform
                else self.compiled.xform_route
            ),
        }
        # Process-wide rows/bytes counters (per loop), added once a loop
        # call. utf8 rows are counted from newline frames when the chunk is
        # a numpy array and stage spans are on; byte counts include the
        # chunk padding the engine processed.
        m = obs.metrics()
        self._c_chunks = {
            "loop1": m.counter("pipeline.loop1_chunks_total"),
            "loop2": m.counter("pipeline.loop2_chunks_total"),
        }
        self._c_rows = {
            "loop1": m.counter("pipeline.loop1_rows_total"),
            "loop2": m.counter("pipeline.loop2_rows_total"),
        }
        self._c_bytes = {
            "loop1": m.counter("pipeline.loop1_bytes_total"),
            "loop2": m.counter("pipeline.loop2_bytes_total"),
        }

    def _chunk_size(self, chunk) -> tuple[int, int]:
        """The rows and bytes one chunk adds to its loop's counters, on the
        host with no device sync: a binary chunk its rows; a utf8 chunk its
        byte size, and its newlines only when it is a numpy array and stage
        spans are on (see the module docstring)."""
        if self.config.input_format != "utf8":
            return int(chunk["label"].shape[0]), 0
        if not isinstance(chunk, np.ndarray):
            return 0, chunk.numel()
        rows = int(np.count_nonzero(chunk == schema_lib.NEWLINE)) if obs.stage_spans() else 0
        return rows, chunk.size

    def _count(self, loop: str, chunks: int, rows: int, nbytes: int) -> None:
        """Add one loop call's totals to the process counters."""
        self._c_chunks[loop].add(chunks)
        self._c_rows[loop].add(rows)
        self._c_bytes[loop].add(nbytes)

    def _stage_split(self, bytes_routed: bool) -> bool:
        """Whether per-chunk work carries nested decode / post-decode spans
        (trace-collection mode; a bytes-routed loop is one launch, and its
        chunk span carries the route)."""
        return (
            obs.stage_spans()
            and self.config.input_format == "utf8"
            and not bytes_routed
        )

    def _tensor(self, x) -> torch.Tensor:
        """``x`` on the engine's device. A pinned host tensor is copied
        without blocking the host (the copy is ordered on the current
        stream, and the caller keeps the buffer until the copy is done);
        a numpy array or pageable tensor is copied as ``Tensor.to`` does."""
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return x.to(self.device, non_blocking=x.device.type == "cpu" and x.is_pinned())

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
        return self.compiled.init_state()

    def vocab_step(self, state: vocab_lib.VocabState, chunk) -> vocab_lib.VocabState:
        """Absorb one chunk through the compiled plan's loop-① half: one
        kernel launch on the fused route, decode included on the bytes-in
        route. The kernels update ``state`` in place."""
        if self._bytes_vocab:
            return self.compiled.vocab_step_bytes(
                state, self._tensor(chunk), max_rows=self.config.max_rows_per_chunk
            )
        return self.compiled.vocab_step(state, self._as_batch(chunk))

    def build_state_stream(self, chunks: Iterable) -> vocab_lib.VocabState:
        """Loop ① over a host iterator, stopping *before* finalization."""
        state = self.init_state()
        split = self._stage_split(self._bytes_vocab)
        spans = split or obs.enabled()
        n_chunks = n_rows = n_bytes = 0
        # Host-side stream-length guard: positions are int32, so a stream
        # may carry at most vocab.MAX_ROWS rows (beyond that the kernels
        # saturate and drop rows). Track a no-sync upper bound (reading
        # rows_seen off the card would sync); only when the bound would
        # cross the ceiling, read the true count and fail loudly if the
        # next chunk could overflow.
        rows_ub = 0
        try:
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
                rows, nbytes = self._chunk_size(chunk)
                n_chunks, n_rows, n_bytes = n_chunks + 1, n_rows + rows, n_bytes + nbytes
                if not spans:
                    state = self.vocab_step(state, chunk)
                    continue
                with obs.span("loop1/chunk", **self._vocab_span_labels):
                    if split:
                        with obs.span("decode"):
                            batch = self._as_batch(chunk)
                        with obs.span("vocab_update", route=self.compiled.vocab_route):
                            state = self.compiled.vocab_step(state, batch)
                    else:
                        state = self.vocab_step(state, chunk)
        finally:
            self._count("loop1", n_chunks, n_rows, n_bytes)
        return state

    def build_vocab_stream(self, chunks: Iterable) -> vocab_lib.Vocabulary:
        """Loop ① over a host iterator (out-of-core / network path)."""
        return vocab_lib.finalize(self.build_state_stream(chunks))

    def build_vocab_scan(self, stacked_chunks) -> vocab_lib.Vocabulary:
        """Loop ① over chunks stacked on a leading axis."""
        state = self.init_state()
        with obs.span("loop1/scan", **self._vocab_span_labels):
            for chunk in self._unstack(stacked_chunks):
                state = self.vocab_step(state, chunk)
        with obs.span("vocab/finalize"):
            return vocab_lib.finalize(state)

    # ------------------------------------------------------------------ #
    # Loop ② — ApplyVocab + dense transforms
    # ------------------------------------------------------------------ #
    def transform_chunk(
        self, vocabulary: vocab_lib.Vocabulary, chunk
    ) -> schema_lib.ProcessedBatch:
        """One chunk through the compiled plan's loop-② half: one kernel
        launch on the fused route, decode included on the bytes-in route."""
        if self._bytes_xform:
            return self.compiled.transform_bytes(
                vocabulary, self._tensor(chunk), max_rows=self.config.max_rows_per_chunk
            )
        return self.compiled.transform(vocabulary, self._as_batch(chunk))

    def frozen_transform(self, vocabulary: vocab_lib.Vocabulary) -> "FrozenVocabTransform":
        """Loop ② as a standalone serving-mode step (see the class)."""
        return FrozenVocabTransform(vocabulary, pipeline=self)

    def transform_stream(
        self, vocabulary: vocab_lib.Vocabulary, chunks: Iterable
    ) -> Iterator[schema_lib.ProcessedBatch]:
        """Loop ② over a host iterator, one output a chunk. Spans (while
        the tracer is on) and counters as in :meth:`build_state_stream`."""
        step = self.frozen_transform(vocabulary)
        spans = obs.enabled() or self._stage_split(self._bytes_xform)
        n_chunks = n_rows = n_bytes = 0
        try:
            for chunk in chunks:
                rows, nbytes = self._chunk_size(chunk)
                n_chunks, n_rows, n_bytes = n_chunks + 1, n_rows + rows, n_bytes + nbytes
                yield step.run(chunk) if spans else self.transform_chunk(vocabulary, chunk)
        finally:
            self._count("loop2", n_chunks, n_rows, n_bytes)

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
        with obs.span("loop2/scan", **self._xform_span_labels):
            return self.transform_scan(vocabulary, stacked_chunks)


class FrozenVocabTransform:
    """Loop ② factored out of the two-loop engine: frozen-vocab serving.

    Wraps a finalized :class:`vocab.Vocabulary` plus the compiled plan's
    loop-② half (Decode → Modulus → ApplyVocab ∥ Neg2Zero → Logarithm for
    the default plan; one bytes-in launch per request when
    ``use_fused_decode`` is on and the plan allows it) behind one
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
    def compiled(self) -> plan_compiler.CompiledPlan:
        """The compiled plan this transform executes (loop-② half)."""
        return self._pipe.compiled

    @property
    def vocabulary(self) -> vocab_lib.Vocabulary:
        return self._vocab

    def swap_vocabulary(self, vocabulary: vocab_lib.Vocabulary) -> None:
        """Replace the frozen vocabulary; callers serialize swaps against
        :meth:`__call__`."""
        self._vocab = vocabulary

    def __call__(self, chunk) -> schema_lib.ProcessedBatch:
        pipe = self._pipe
        rows, nbytes = pipe._chunk_size(chunk)
        pipe._count("loop2", 1, rows, nbytes)
        return self.run(chunk)

    def run(self, chunk) -> schema_lib.ProcessedBatch:
        """One chunk inside its ``loop2/chunk`` span, uncounted (a loop
        counts its chunks once a call)."""
        pipe = self._pipe
        with obs.span("loop2/chunk", **pipe._xform_span_labels):
            if pipe._stage_split(pipe._bytes_xform):
                with obs.span("decode"):
                    batch = pipe._as_batch(chunk)
                with obs.span("transform", route=pipe.compiled.xform_route):
                    return pipe.compiled.transform(self._vocab, batch)
            return pipe.transform_chunk(self._vocab, chunk)


def flatten_processed(out: schema_lib.ProcessedBatch) -> schema_lib.ProcessedBatch:
    """[n_chunks, rows, ...] → [n_chunks*rows, ...] (keeps padding rows)."""
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    return schema_lib.ProcessedBatch(
        label=flat(out.label),
        dense=flat(out.dense),
        sparse=flat(out.sparse),
        valid=flat(out.valid),
    )
