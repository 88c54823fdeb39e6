"""Micro-batch coalescing scheduler: fixed shapes over a request stream.

Counterpart of ``repro/stream/scheduler.py``. The streaming service
receives *variable-size* row requests; the scheduler serves them at a
few fixed shapes, so the kernels only ever see ``len(buckets)`` input
shapes and every buffer is made once:

  * requests are coalesced FIFO into **micro-batches**;
  * each micro-batch is padded to the smallest of a small set of
    **bucket capacities** (default {1Ki, 4Ki, 16Ki} rows) — the same
    padded bytes (utf8) or zero rows with ``valid=False`` (binary) that
    the reference builds, so the kernels see what the reference's see;
  * each bucket owns a :class:`~repro_torch.core.pipeline.FrozenVocabTransform`
    (loop ② with the offline-finalized vocabulary) sized to its capacity.
    Every bucket executes the *same* compiled plan — the one named by
    ``config.plan`` (default: the Criteo chain);
  * results are **routed back per request** by row span: concatenated
    request rows decode to contiguous output rows (the decoder assigns
    row *k* to the *k*-th newline), so the route step is a slice.

The reference relies on JAX's jit cache for its shape discipline and on
asynchronous dispatch for its overlap. Here:

  * Nothing compiles, so ``stream.recompiles_total`` counts what a jit
    cache would grow by at :meth:`MicroBatchScheduler.dispatch`: each new
    input signature (shapes, dtypes and devices of the chunk and of the
    table), and each batch on a known one during which the loop thread
    made or regrew device scratch (``kernels/_scratch.py``). After one
    warm-up batch per bucket it stays flat. Only ``dispatch`` keeps this
    count; the engine's offline loops pay nothing for it.
  * Each bucket keeps two staging slots of host input buffers. On CUDA
    they are **pinned**, so the engine's copy in is asynchronous
    (``PiperPipeline._tensor``) and the host assembles batch *i+1* while
    batch *i* runs. A slot is refilled only after the event recorded
    behind its last copy in. At dispatch the outputs are copied back
    into pinned host buffers of the batch's own (from PyTorch's caching
    host allocator, which reuses a block only after the copies that used
    it) right behind the batch's kernels, and an event is recorded there,
    before the next batch is enqueued; :meth:`route` waits on that event
    alone, never on a later batch's kernels. Routed results are copies:
    the requests own their memory, and no result is a view into a buffer
    that a later batch overwrites.

Both input formats are supported, matching ``PipelineConfig``:
``"utf8"`` requests carry row-framed encoded bytes (paper Config I/II);
``"binary"`` requests carry pre-decoded ``{label, dense, sparse}``
columns (Config III).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.kernels import _scratch

DEFAULT_BUCKET_ROWS = (1024, 4096, 16384)

# The output fields routed back to requests, in order.
FIELDS = ("label", "dense", "sparse")

# Staging slots per bucket: batch i+1 is filled while batch i may still
# be copying in, and at most two batches are outstanding.
SLOTS_PER_BUCKET = 2


class StreamRequest:
    """One in-flight preprocessing request — also the caller's handle.

    ``payload`` is either a uint8 array of whole encoded rows (utf8) or a
    ``{label, dense, sparse}`` dict of per-row arrays (binary). The
    service fills the timing fields; :meth:`result` blocks until the
    request's rows come back from the device (or the service failed).
    """

    def __init__(self, payload, n_rows: int, n_bytes: int):
        self.payload = payload
        self.n_rows = n_rows
        self.n_bytes = n_bytes
        self.submit_t: float | None = None
        self.done_t: float | None = None
        self._done = threading.Event()
        self._result: dict | None = None
        self._error: BaseException | None = None

    def result(self, timeout: float | None = None) -> dict:
        """Blocking fetch: ``{label, dense, sparse}`` numpy arrays with
        exactly ``n_rows`` rows (padding already stripped)."""
        if not self._done.wait(timeout):
            raise TimeoutError("stream request not completed in time")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_s(self) -> float | None:
        if self.submit_t is None or self.done_t is None:
            return None
        return self.done_t - self.submit_t

    # -- service side ------------------------------------------------- #
    def _finish(self, result: dict) -> None:
        self._result = result
        if self.done_t is None:
            self.done_t = time.perf_counter()
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        if self.done_t is None:
            self.done_t = time.perf_counter()
        self._done.set()


class CompositeRequest:
    """Caller handle for an oversized request served as several sub-chunks.

    The scheduler's buckets cap one micro-batch at ``max_rows`` /
    ``max_bytes``; a larger request is **split** at submission into
    bucket-sized sub-requests (:meth:`MicroBatchScheduler.split`) whose
    row spans reassemble, in order, to the original request — so bulk
    callers get the same ``result()`` surface instead of a rejection.
    Sub-requests flow through the ordinary FIFO path (they are coalesced
    and padded like any other request), and each records its own
    latency/throughput metrics.
    """

    def __init__(self, parts: list[StreamRequest]):
        if not parts:
            raise ValueError("composite request needs at least one part")
        self.parts = parts
        self.n_rows = sum(p.n_rows for p in parts)
        self.n_bytes = sum(p.n_bytes for p in parts)

    def result(self, timeout: float | None = None) -> dict:
        """Blocking fetch: the per-part results concatenated back into
        one ``{label, dense, sparse}`` table of exactly ``n_rows`` rows
        (sub-chunk order == original row order). ``timeout`` bounds the
        *total* wait across parts."""
        deadline = None if timeout is None else time.monotonic() + timeout
        outs = []
        for p in self.parts:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            outs.append(p.result(left))
        return {k: np.concatenate([o[k] for o in outs]) for k in FIELDS}

    @property
    def done(self) -> bool:
        return all(p.done for p in self.parts)

    @property
    def submit_t(self) -> float | None:
        return self.parts[0].submit_t

    @property
    def done_t(self) -> float | None:
        ts = [p.done_t for p in self.parts]
        return None if any(t is None for t in ts) else max(ts)

    @property
    def latency_s(self) -> float | None:
        if self.submit_t is None or self.done_t is None:
            return None
        return self.done_t - self.submit_t


def make_request(payload, config: pipeline_lib.PipelineConfig) -> StreamRequest:
    """Validate + wrap a raw payload for ``config.input_format``."""
    schema = config.schema
    if config.input_format == "utf8":
        buf = np.asarray(payload, dtype=np.uint8)
        if buf.ndim != 1 or buf.size == 0:
            raise ValueError("utf8 payload must be a non-empty 1-D byte array")
        if buf[-1] != schema_lib.NEWLINE:
            raise ValueError("utf8 payload must hold whole rows (end with \\n)")
        n_rows = int((buf == schema_lib.NEWLINE).sum())
        return StreamRequest(buf, n_rows=n_rows, n_bytes=int(buf.size))
    cols = {k: np.asarray(payload[k], dtype=np.int32) for k in FIELDS}
    if cols["label"].ndim != 1:
        raise ValueError(f"binary label must be 1-D, got shape {cols['label'].shape}")
    n_rows = cols["label"].shape[0]
    if n_rows == 0:
        raise ValueError("binary payload must hold at least one row")
    if cols["dense"].shape != (n_rows, schema.n_dense) or cols["sparse"].shape != (
        n_rows,
        schema.n_sparse,
    ):
        raise ValueError(
            f"binary payload shapes {cols['dense'].shape}/{cols['sparse'].shape} "
            f"do not match schema (n_dense={schema.n_dense}, n_sparse={schema.n_sparse})"
        )
    return StreamRequest(cols, n_rows=n_rows, n_bytes=0)


class Staging:
    """One staging slot of a bucket: the padded host input of one batch
    (pinned on CUDA), and the event behind its last copy in."""

    def __init__(self, rows: int, chunk_bytes: int, config: pipeline_lib.PipelineConfig):
        dev = config.torch_device
        self.cuda = dev.type == "cuda"
        pin = self.cuda
        sch = config.schema
        if config.input_format == "utf8":
            self.chunk = torch.zeros(chunk_bytes, dtype=torch.uint8, pin_memory=pin)
        else:
            self.chunk = {
                "label": torch.zeros(rows, dtype=torch.int32, pin_memory=pin),
                "dense": torch.zeros((rows, sch.n_dense), dtype=torch.int32, pin_memory=pin),
                "sparse": torch.zeros((rows, sch.n_sparse), dtype=torch.int32, pin_memory=pin),
                "valid": torch.zeros(rows, dtype=torch.bool, pin_memory=pin),
            }
        # the rows (binary) or bytes (utf8) the last batch filled: the
        # next batch zeroes what it leaves of them
        self.filled = 0
        self.copied: torch.cuda.Event | None = None

    def reusable(self) -> None:
        """Block until the device has read this slot's last input."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None


@dataclasses.dataclass
class Bucket:
    """One fixed capacity: rows, utf8 byte capacity, compiled transform,
    its staging slots (used in turn), and the input signatures its
    batches have run, with the batches that made scratch on a known one."""

    rows: int
    chunk_bytes: int
    transform: pipeline_lib.FrozenVocabTransform
    slots: list[Staging]
    turn: int = 0
    signatures: set = dataclasses.field(default_factory=set)
    regrowths: int = 0

    def next_slot(self) -> Staging:
        slot = self.slots[self.turn]
        self.turn = (self.turn + 1) % len(self.slots)
        return slot


@dataclasses.dataclass
class MicroBatch:
    """A packed step: the padded chunk, its staging slot, per-request
    output row spans, and, once dispatched on CUDA, the pinned host
    buffers its outputs come back to and the event behind those copies."""

    bucket: Bucket
    requests: list[StreamRequest]
    spans: list[tuple[int, int]]
    slot: Staging
    outputs: dict | None = None
    returned: torch.cuda.Event | None = None

    @property
    def chunk(self):
        """uint8 [chunk_bytes] (utf8) or {label,dense,sparse,valid} tensors."""
        return self.slot.chunk

    @property
    def n_rows(self) -> int:
        return self.spans[-1][1] if self.spans else 0


class MicroBatchScheduler:
    """Packs requests into bucketed fixed-shape chunks and routes results.

    Pure packing + dispatch — no threads. The service loop drives it:
    its ``_gather`` coalesces queued requests FIFO using :meth:`fits`,
    then ``assemble`` fills a staging slot, ``dispatch`` launches the
    device transform and its copies back, and ``route`` waits for that
    batch's copies and slices them per request. On CUDA, call
    ``dispatch`` and ``route`` of one batch on the same stream.

    Args:
      config: the shared :class:`~repro_torch.core.pipeline.PipelineConfig`
        (``max_rows_per_chunk``/``chunk_bytes`` are overridden per bucket).
      vocabulary: the frozen offline-built vocabulary.
      bucket_rows: ascending row capacities. A request larger than the
        biggest bucket is not rejected: the service **splits** it at
        submission into bucket-sized sub-chunks (:meth:`split`) whose
        results reassemble per row span behind one
        :class:`CompositeRequest` handle.
      bytes_per_row: utf8 byte budget per bucket row. The default —
        ``schema.max_row_bytes`` — guarantees any row-fitting batch also
        byte-fits; smaller values trade buffer memory for the chance that
        the byte axis, not the row axis, picks the bucket.
      registry: the :class:`repro_torch.obs.Registry` the packing metrics
        land in (bucket occupancy / padding-waste histograms, the
        recompile counter). The service passes its own; standalone
        schedulers get a private one.
    """

    def __init__(
        self,
        config: pipeline_lib.PipelineConfig,
        vocabulary: vocab_lib.Vocabulary,
        bucket_rows: tuple[int, ...] = DEFAULT_BUCKET_ROWS,
        bytes_per_row: int | None = None,
        registry: obs.Registry | None = None,
    ):
        if not bucket_rows:
            raise ValueError("need at least one bucket capacity")
        self.config = config
        self.schema = config.schema
        self.plan = config.resolved_plan()
        self.registry = registry if registry is not None else obs.Registry()
        self._c_batches = self.registry.counter(
            "stream.batches_total", "dispatched micro-batches"
        )
        self._h_occupancy = self.registry.histogram(
            "stream.bucket_occupancy", "valid rows / bucket capacity per batch"
        )
        self._h_padding = self.registry.histogram(
            "stream.padding_rows", "wasted (padded) rows per batch"
        )
        # Steady-state shape discipline, as a first-class signal: any
        # signature or scratch made past warmup increments this (the
        # no-recompile guarantee asserts it stays flat).
        self._c_recompiles = self.registry.counter(
            "stream.recompiles_total", "input signatures or scratch made at dispatch"
        )
        self.bytes_per_row = (
            int(bytes_per_row) if bytes_per_row else config.schema.max_row_bytes
        )
        self.buckets: list[Bucket] = []
        for rows in sorted(set(int(r) for r in bucket_rows)):
            chunk_bytes = rows * self.bytes_per_row
            bucket_cfg = dataclasses.replace(
                config, max_rows_per_chunk=rows, chunk_bytes=chunk_bytes
            )
            transform = pipeline_lib.FrozenVocabTransform(vocabulary, config=bucket_cfg)
            slots = [Staging(rows, chunk_bytes, bucket_cfg) for _ in range(SLOTS_PER_BUCKET)]
            self.buckets.append(Bucket(rows, chunk_bytes, transform, slots))

    # -- capacity queries --------------------------------------------- #
    @property
    def max_rows(self) -> int:
        return self.buckets[-1].rows

    @property
    def max_bytes(self) -> int:
        return self.buckets[-1].chunk_bytes

    def admits(self, req: StreamRequest) -> bool:
        """Whether the request fits the largest bucket at all."""
        if req.n_rows > self.max_rows:
            return False
        return self.config.input_format != "utf8" or req.n_bytes <= self.max_bytes

    def split(self, req: StreamRequest) -> list[StreamRequest]:
        """Split an oversized request into admitted, bucket-sized parts.

        Sub-chunks cut at whole-row boundaries, each within the largest
        bucket on both the row and (utf8) byte axes; concatenating the
        parts' rows in order reproduces the original request exactly. An
        already-admitted request passes through as ``[req]``. Raises
        :class:`ValueError` only when a *single row* exceeds the largest
        bucket's byte capacity (no split can help there).
        """
        if self.admits(req):
            return [req]
        parts: list[StreamRequest] = []
        if self.config.input_format == "utf8":
            buf = np.asarray(req.payload)
            # exclusive end byte of every encoded row (incl. its newline)
            ends = np.flatnonzero(buf == schema_lib.NEWLINE) + 1
            row0, byte0 = 0, 0
            while row0 < ends.size:
                hi = min(row0 + self.max_rows, ends.size)
                # the byte axis may bind first: longest whole-row prefix
                hi = min(
                    hi,
                    int(np.searchsorted(ends, byte0 + self.max_bytes, side="right")),
                )
                if hi <= row0:
                    raise ValueError(
                        f"row {row0} of the request is {int(ends[row0] - byte0)} "
                        f"bytes — larger than the biggest bucket "
                        f"({self.max_bytes} bytes); no row-aligned split exists"
                    )
                part = buf[byte0 : int(ends[hi - 1])]
                parts.append(
                    StreamRequest(part, n_rows=hi - row0, n_bytes=int(part.size))
                )
                row0, byte0 = hi, int(ends[hi - 1])
        else:
            cols = req.payload
            for lo in range(0, req.n_rows, self.max_rows):
                hi = min(lo + self.max_rows, req.n_rows)
                parts.append(
                    StreamRequest(
                        {k: v[lo:hi] for k, v in cols.items()},
                        n_rows=hi - lo,
                        n_bytes=0,
                    )
                )
        return parts

    def fits(self, rows: int, nbytes: int, req: StreamRequest) -> bool:
        """Whether ``req`` still fits a batch already holding rows/bytes."""
        if rows + req.n_rows > self.max_rows:
            return False
        return (
            self.config.input_format != "utf8"
            or nbytes + req.n_bytes <= self.max_bytes
        )

    def select_bucket(self, rows: int, nbytes: int) -> Bucket:
        """Smallest bucket covering the batch on both axes."""
        for b in self.buckets:
            if rows <= b.rows and (
                self.config.input_format != "utf8" or nbytes <= b.chunk_bytes
            ):
                return b
        raise ValueError(
            f"batch of {rows} rows / {nbytes} bytes exceeds the largest bucket "
            f"({self.max_rows} rows / {self.max_bytes} bytes)"
        )

    # -- packing ------------------------------------------------------- #
    def assemble(self, requests: list[StreamRequest]) -> MicroBatch:
        """Pack coalesced requests into the next staging slot of their
        bucket: one fixed-shape padded chunk."""
        spans, row = [], 0
        for r in requests:
            spans.append((row, row + r.n_rows))
            row += r.n_rows
        nbytes = sum(r.n_bytes for r in requests)
        bucket = self.select_bucket(row, nbytes)
        self._c_batches.add(1)
        self._h_occupancy.observe(row / bucket.rows)
        self._h_padding.observe(bucket.rows - row)

        slot = bucket.next_slot()
        slot.reusable()
        if self.config.input_format == "utf8":
            chunk = slot.chunk.numpy()
            cursor = 0
            for r in requests:
                chunk[cursor : cursor + r.n_bytes] = r.payload
                cursor += r.n_bytes
            if cursor < slot.filled:
                chunk[cursor : slot.filled] = 0
            slot.filled = cursor
        else:
            cols = {k: slot.chunk[k].numpy() for k in (*FIELDS, "valid")}
            cursor = 0
            for r in requests:
                n = r.n_rows
                for k in FIELDS:
                    cols[k][cursor : cursor + n] = r.payload[k]
                cursor += n
            if cursor < slot.filled:
                for k in FIELDS:
                    cols[k][cursor : slot.filled] = 0
            cols["valid"][:cursor] = True
            cols["valid"][cursor:] = False
            slot.filled = cursor
        return MicroBatch(bucket=bucket, requests=requests, spans=spans, slot=slot)

    # -- execution ----------------------------------------------------- #
    def dispatch(self, batch: MicroBatch) -> schema_lib.ProcessedBatch:
        """Launch the bucket's transform on the current stream. On CUDA
        the copy in is asynchronous (the slot is pinned), and the copies
        of the outputs back to the batch's own pinned buffers are enqueued
        right behind its kernels, with an event after them: the call
        returns without waiting for the device, which is what lets the
        service assemble batch *i+1* while *i* runs.

        A new input signature, or scratch made on a known one, increments
        ``stream.recompiles_total`` (see the module docstring) — warmup
        shows ``len(buckets)``, steady state must show zero.
        """
        bucket = batch.bucket
        made = _scratch.made_here()
        out = bucket.transform(batch.chunk)
        signature = _signature(batch.chunk, bucket.transform.vocabulary)
        if signature not in bucket.signatures:
            bucket.signatures.add(signature)
            self._c_recompiles.add(1)
        elif _scratch.made_here() != made:
            bucket.regrowths += 1
            self._c_recompiles.add(1)
        if batch.slot.cuda:
            stream = torch.cuda.current_stream(self.config.torch_device)
            batch.slot.copied = stream.record_event()
            batch.outputs = {}
            for k in FIELDS:
                dev = getattr(out, k)
                host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
                batch.outputs[k] = host.copy_(dev, non_blocking=True)
            batch.returned = stream.record_event()
        return out

    def route(self, batch: MicroBatch, out: schema_lib.ProcessedBatch) -> list[dict]:
        """Wait for the batch's outputs and slice them per request (batch
        order), each request's rows copied into arrays of its own. On CUDA
        this waits on the event behind this batch's copies back, not on
        any batch dispatched after it. The caller finishes the requests —
        the service records latency *before* unblocking waiters, so a
        metrics reset right after ``result()`` returns can never lose the
        record."""
        if batch.returned is not None:
            batch.returned.synchronize()
            host = {k: batch.outputs[k].numpy() for k in FIELDS}
        else:
            host = {k: getattr(out, k).numpy() for k in FIELDS}
        return [{k: host[k][lo:hi].copy() for k in FIELDS} for (lo, hi) in batch.spans]

    # -- vocab + compile bookkeeping ----------------------------------- #
    @property
    def compiled(self):
        """The :class:`~repro_torch.core.plan_compiler.CompiledPlan` the
        buckets execute — one program, instantiated per bucket shape."""
        return self.buckets[0].transform.compiled

    def swap_vocabulary(self, vocabulary: vocab_lib.Vocabulary) -> None:
        """Swap the frozen vocabulary on every bucket (between steps)."""
        for b in self.buckets:
            b.transform.swap_vocabulary(vocabulary)

    def compile_cache_size(self) -> int:
        """Total signatures and scratch growths across buckets — the
        shape discipline means this saturates at warmup and never grows."""
        return sum(len(b.signatures) + b.regrowths for b in self.buckets)


def _signature(chunk, vocabulary: vocab_lib.Vocabulary) -> tuple:
    """Shapes, dtypes and devices of a chunk (utf8 bytes or a binary dict)
    and of the table it is served with."""
    leaves = sorted(chunk.items()) if isinstance(chunk, dict) else [("", chunk)]
    table = vocabulary.table
    return tuple((k, v.shape, v.dtype, v.device) for k, v in leaves) + (
        (table.shape, table.dtype, table.device),)
