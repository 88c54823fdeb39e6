"""Online streaming preprocessing service (Piper-as-a-service).

Counterpart of ``repro/stream/service.py``. The offline engine
(``PiperPipeline``) is throughput-bound: two full passes over a finite
dataset. This module is the *latency-bound* counterpart — a long-lived
service serving the Piper operator chain in **frozen-vocab mode** (loop
② only) over a continuous request stream:

  * **ingress** — a bounded queue; ``submit`` blocks when the service
    falls behind (backpressure instead of unbounded memory growth);
  * **micro-batching** — ``scheduler.MicroBatchScheduler`` coalesces
    variable-size requests into bucketed fixed shapes, so steady state
    makes no new signature and no new scratch;
  * **double buffering** — one micro-batch is always in flight: the loop
    dispatches batch *i* (the copy in, the kernels and the copies back
    are all asynchronous on CUDA: the staging buffers are pinned), then
    assembles batch *i+1* in the other staging slot while *i* runs, then
    waits on *i*'s event alone to route it;
  * **incremental vocab refresh** — un-finalized
    :class:`~repro_torch.core.vocab.VocabState` deltas fold into the
    service's state with the commutative-monoid ``vocab.merge`` and the
    re-finalized vocabulary is swapped in **atomically between steps**,
    so no request ever sees a half-updated table. The service can also
    run loop ① *itself* on a payload (``absorb``): the chunk goes through
    the compiled plan's vocab half — one ``fused_genvocab`` (or
    ``fused_genvocab_slabs`` with counts) launch after decode, or one
    ``fused_decode_genvocab`` launch from raw bytes with
    ``use_fused_decode`` — and the delta merges in through the same
    refresh path;
  * **graceful drain/shutdown** — ``drain`` waits for every accepted
    request; ``stop`` drains then joins the loop (idempotent).

Streams (CUDA). The loop thread runs every dispatch, merge, finalize and
swap inside ``torch.cuda.stream(self._stream)``, a stream the service
owns. ``absorb`` and ``refresh_vocab`` run on the caller's current
stream: a delta carries an event recorded there, the loop stream waits
on it before the merge, and the delta's tensors are marked as used on
the loop stream (``record_stream``) so the caching allocator does not
hand their memory out early. The state passed at construction is handed
over the same way. Reading the state back (``vocab_state``, the default
``absorb`` offset) first makes the reader's stream wait for the loop
stream.

Determinism contract: for any interleaving of requests whose rows
concatenate to a reference dataset, the per-request outputs reassemble
to exactly ``PiperPipeline`` loop ②'s table, including across a
mid-stream vocab refresh whose delta only appends later
first-occurrences.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.data import chunk_cache as chunk_cache_lib
from repro_torch.obs import stall as stall_lib
from repro_torch.stream import metrics as metrics_lib
from repro_torch.stream import scheduler as scheduler_lib


def _record_state(state: vocab_lib.VocabState, stream: torch.cuda.Stream) -> None:
    """Mark a state's tensors as used on ``stream``, so the caching
    allocator keeps their memory until ``stream``'s work so far is done."""
    for t in (state.first_pos, state.rows_seen, state.counts):
        if t is not None:
            t.record_stream(stream)


def padded_chunk(req: scheduler_lib.StreamRequest, config: pipeline_lib.PipelineConfig):
    """One request as a chunk of ``config``'s geometry, as ``absorb`` runs
    it through loop ①: the bytes then zeros (utf8), or the rows then zero
    rows with ``valid=False`` (binary)."""
    if config.input_format == "utf8":
        chunk = np.zeros(config.chunk_bytes, np.uint8)
        chunk[: req.n_bytes] = req.payload
        return chunk
    cap, sch = config.max_rows_per_chunk, config.schema
    chunk = {
        "label": np.zeros(cap, np.int32),
        "dense": np.zeros((cap, sch.n_dense), np.int32),
        "sparse": np.zeros((cap, sch.n_sparse), np.int32),
        "valid": np.arange(cap) < req.n_rows,
    }
    for k in scheduler_lib.FIELDS:
        chunk[k][: req.n_rows] = req.payload[k]
    return chunk


class StreamingPreprocessService:
    """Long-lived frozen-vocab preprocessing service.

    Args:
      config: the shared :class:`~repro_torch.core.pipeline.PipelineConfig`
        (``input_format`` selects utf8 vs binary requests; per-bucket
        shape fields are overridden by the scheduler; ``device`` is where
        the service runs, the card by default). ``config.plan`` names the
        plan to serve — every bucket executes its compiled frozen-transform
        half, so the online path runs exactly the program the offline
        engine ran. The fused hints are inherited unchanged, and so is
        ``use_fused_decode`` (utf8 requests): every bucket's transform
        then routes its padded byte chunk through the bytes-in loop-②
        kernel, and ``absorb`` ingests through the bytes-in loop-① kernel.
      vocab_state: the **un-finalized** loop-① accumulator from an
        offline run (``PiperPipeline.build_state_stream``) of the *same
        plan*. Kept un-finalized so :meth:`refresh_vocab` can merge in
        deltas; the service finalizes internally. The service takes it
        over: its tensors are handed to the service's stream.
      bucket_rows / bytes_per_row: scheduler capacities (see
        :class:`~repro_torch.stream.scheduler.MicroBatchScheduler`).
      queue_depth: ingress bound — the backpressure knob.
      poll_s: loop idle poll interval.
      registry: the :class:`repro_torch.obs.Registry` every service signal
        lands in (request metrics, stall buckets, queue gauges, packing
        histograms, recompile counter, swap times). Default: a private
        registry per service.
      finalizer: how the service turns the merged state into the serving
        :class:`~repro_torch.core.vocab.Vocabulary` — default
        ``vocab.finalize``; a frequency-capped finalizer such as
        ``lambda st: vocab.finalize_topk(st, 10_000)`` needs a state built
        with ``track_vocab_counts``. Applied at construction and after
        every refresh merge.
      cache: optional :class:`~repro_torch.data.chunk_cache.ChunkCache`.
        When set, every request is looked up by content-addressed key
        (sha256 of its raw payload ⊕ plan signature ⊕ current vocab
        digest) *before* loop-② dispatch: hits complete immediately with
        the cached table — never touching the scheduler or the device —
        and each miss's routed result is inserted on completion. The vocab
        digest is recomputed at every swap (a copy of the table back to
        the host, timed in ``stream.vocab_digest_s``).
    """

    def __init__(
        self,
        config: pipeline_lib.PipelineConfig,
        vocab_state: vocab_lib.VocabState,
        bucket_rows: tuple[int, ...] = scheduler_lib.DEFAULT_BUCKET_ROWS,
        bytes_per_row: int | None = None,
        queue_depth: int = 64,
        poll_s: float = 0.005,
        registry: obs.Registry | None = None,
        finalizer=vocab_lib.finalize,
        cache: chunk_cache_lib.ChunkCache | None = None,
    ):
        self.config = config
        self.device = config.torch_device
        self._stream: torch.cuda.Stream | None = None
        if self.device.type == "cuda":
            # the loop's own stream: it first waits for the work that made
            # the state, which it now owns
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            _record_state(vocab_state, self._stream)
        self._state = vocab_state
        self._finalizer = finalizer
        self.registry = registry if registry is not None else obs.Registry()
        self._h_swap = self.registry.histogram(
            "stream.vocab_swap_s", "loop-thread seconds of a merge + finalize + swap"
        )
        self._h_digest = self.registry.histogram(
            "stream.vocab_digest_s", "seconds to digest a swapped vocabulary (cache)"
        )
        with self._on_stream():
            vocabulary = finalizer(vocab_state)
        self.cache = cache
        if cache is not None:
            self._plan_sig = chunk_cache_lib.plan_signature(config)
            if self._stream is not None:
                self._stream.synchronize()  # time the digest, not the finalize
            t0 = time.perf_counter()
            with self._on_stream():
                self._vocab_digest = chunk_cache_lib.vocab_digest(vocabulary)
            self._h_digest.observe(time.perf_counter() - t0)
        self.scheduler = scheduler_lib.MicroBatchScheduler(
            config,
            vocabulary,
            bucket_rows=bucket_rows,
            bytes_per_row=bytes_per_row,
            registry=self.registry,
        )
        self.plan = self.scheduler.plan
        # Fail at construction, not at first dispatch: a state built with a
        # different plan (wrong vocab-column count or modulus range) would
        # otherwise surface as a shape error deep inside the first launch.
        compiled = self.scheduler.compiled
        want = (compiled.n_vocab_columns, compiled.vocab_range)
        got = tuple(int(x) for x in vocab_state.first_pos.shape)
        if got != want:
            raise ValueError(
                f"vocab_state shape {got} does not match the plan's vocab "
                f"layout {want}; build loop ① with the same PipelineConfig.plan"
            )
        if (vocab_state.counts is not None) != compiled.track_counts:
            raise ValueError(
                "vocab_state count tracking does not match "
                f"PipelineConfig.track_vocab_counts={compiled.track_counts}; "
                "build loop ① with the same config"
            )
        # Loop-① ingestion engine for absorb(): the SAME compiled plan's
        # vocab half as the offline engine, so online-ingested deltas are
        # bit-identical to offline-built ones.
        self._ingest = pipeline_lib.PiperPipeline(config)
        self._absorb_lock = threading.Lock()
        self.metrics = metrics_lib.ServiceMetrics(self.registry)
        # Stall attribution: the service loop laps this clock at every
        # phase boundary, so its wall time splits exhaustively into
        # queue-wait / host-assembly / device-dispatch / vocab-merge
        # (see repro_torch.obs.stall; stall_report() is the snapshot).
        self._stall = stall_lib.StallClock(self.registry)
        self._g_qdepth = self.registry.gauge(
            "stream.ingress_depth", "requests queued in the bounded ingress"
        )
        self._h_backpressure = self.registry.histogram(
            "stream.backpressure_wait_s", "submit-side blocking on a full ingress"
        )
        self._c_overlap = self.registry.counter(
            "stream.overlap_assembly_s",
            "host assembly+dispatch seconds hidden behind an in-flight batch",
        )
        self._c_refresh = self.registry.counter(
            "stream.vocab_refresh_total", "loop-1 deltas accepted"
        )
        self._c_apply = self.registry.counter(
            "stream.vocab_apply_total", "atomic vocabulary swaps applied"
        )
        self._c_absorb = self.registry.counter(
            "stream.absorb_total", "payloads ingested through online loop-1"
        )
        self._ingress: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._carry: scheduler_lib.StreamRequest | None = None
        self._pending_delta: vocab_lib.VocabState | None = None
        # the event behind the pending delta's last producer (CUDA)
        self._pending_event: torch.cuda.Event | None = None
        # events around the last swap on the loop stream (CUDA)
        self._swap_events: tuple[torch.cuda.Event, torch.cuda.Event] | None = None
        self._vocab_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._outstanding = 0
        self._cond = threading.Condition()
        self._poll_s = poll_s
        # Serializes submit()'s check-then-put against stop()'s final
        # ingress sweep, so no request can slip in behind the sweep and
        # strand (its put either lands before the sweep or the stop flag
        # is already visible to the check).
        self._submit_lock = threading.Lock()

    def _on_stream(self):
        """The loop stream as the current stream (CUDA); nothing on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "StreamingPreprocessService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(
            target=self._run, name="piper-stream-service", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful shutdown: drain accepted requests, stop the loop.

        Idempotent — safe to call twice or from ``finally`` blocks. Any
        request that slipped into the ingress after the loop exited is
        failed (never silently dropped)."""
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        # _carry is loop-thread state; the join above is the only
        # synchronization it needs, so keep it out of _submit_lock
        leftovers = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        with self._submit_lock:
            while True:
                try:
                    leftovers.append(self._ingress.get_nowait())
                except queue.Empty:
                    break
        self._fail_requests(
            leftovers, RuntimeError("streaming service stopped before completion")
        )

    def __enter__(self) -> "StreamingPreprocessService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    # client surface
    # ------------------------------------------------------------------ #
    def submit(self, payload, timeout: float | None = None):
        """Enqueue one request; returns its handle.

        Blocks (up to ``timeout``) while the bounded ingress is full —
        that *is* the backpressure: a producer outrunning the device is
        slowed at submission instead of ballooning host memory.

        A request larger than the biggest bucket is split at whole-row
        boundaries into bucket-sized sub-chunks
        (:meth:`~repro_torch.stream.scheduler.MicroBatchScheduler.split`)
        and served behind one
        :class:`~repro_torch.stream.scheduler.CompositeRequest` handle whose
        ``result()`` reassembles the parts' row spans in order. If the
        ingress fills mid-split, the parts already enqueued still
        complete — the raised ``queue.Full`` tells the caller the
        request was not fully admitted, and carries the admitted-prefix
        handle as ``exc.partial_request`` (absent when nothing was
        admitted) so those rows stay waitable and a retry can resubmit
        only the remainder.
        """
        req = scheduler_lib.make_request(payload, self.config)
        if not self.scheduler.admits(req):
            # one TOTAL deadline across parts (the documented "blocks up
            # to timeout" bound), not a per-part allowance
            deadline = None if timeout is None else time.monotonic() + timeout
            handles: list[scheduler_lib.StreamRequest] = []
            for p in self.scheduler.split(req):
                left = (
                    None
                    if deadline is None
                    else max(0.0, deadline - time.monotonic())
                )
                try:
                    handles.append(self._enqueue(p, left))
                except BaseException as e:
                    if handles:
                        e.partial_request = scheduler_lib.CompositeRequest(handles)
                    raise
            return scheduler_lib.CompositeRequest(handles)
        return self._enqueue(req, timeout)

    def _enqueue(
        self, req: scheduler_lib.StreamRequest, timeout: float | None = None
    ) -> scheduler_lib.StreamRequest:
        if self._thread is None:
            raise RuntimeError("service not started")
        if self.cache is not None:
            # Hash on the client thread: the digest is content-only (no
            # vocab/plan component), so it cannot go stale, and it keeps
            # sha256 work off the single service-loop thread.
            req._raw_digest = chunk_cache_lib.raw_digest(req.payload)
        with self._submit_lock:
            if self._stop_evt.is_set():
                raise RuntimeError("streaming service is stopping")
            if self._error is not None:
                raise RuntimeError("streaming service failed") from self._error
            with self._cond:
                self._outstanding += 1
            req.submit_t = time.perf_counter()
            self.metrics.note_submit(req.submit_t)
            try:
                # The put blocks while the ingress is full — that IS the
                # backpressure; its duration is the producer-side stall.
                self._ingress.put(req, timeout=timeout)
            except queue.Full:
                self._h_backpressure.observe(time.perf_counter() - req.submit_t)
                with self._cond:
                    self._outstanding -= 1
                    self._cond.notify_all()  # a waiting drain() may now be done
                raise
            self._h_backpressure.observe(time.perf_counter() - req.submit_t)
            self._g_qdepth.set(self._ingress.qsize())
        if self._error is not None:
            # The loop died while (or right before) we enqueued: its
            # ingress sweep may have missed this request — sweep again so
            # nothing strands (double sweeps are harmless, gets are atomic).
            doomed = []
            while True:
                try:
                    doomed.append(self._ingress.get_nowait())
                except queue.Empty:
                    break
            self._fail_requests(doomed, RuntimeError("streaming service failed"))
        return req

    def warmup(self, payloads) -> None:
        """Run the payloads through (one per bucket capacity, typically),
        making each bucket's signature and scratch, then reset metrics so
        the steady-state numbers exclude it. Latency is recorded before
        ``result()`` unblocks, so the reset cannot race a warmup record
        into the fresh metrics."""
        for p in payloads:
            self.submit(p).result()
        self.metrics.reset()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every accepted request has completed."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._outstanding == 0 or self._error is not None,
                timeout=timeout,
            )
        if self._error is not None:
            raise RuntimeError("streaming service failed") from self._error
        if not ok:
            raise TimeoutError("drain timed out")

    def refresh_vocab(self, delta_state: vocab_lib.VocabState) -> None:
        """Fold a loop-① delta into the serving vocabulary.

        Thread-safe and non-blocking: deltas accumulate under a lock via
        the commutative-monoid ``vocab.merge`` and the service loop
        applies them **between micro-batch steps** — finalize, then one
        atomic swap across all bucket transforms. In-flight steps keep
        the old table; no step ever mixes the two. On CUDA the delta is
        taken to be made on the caller's current stream: an event recorded
        there orders the loop's merge after it.

        An incompatible delta (different vocab layout or dtype, or
        counts-tracking mismatch) raises :class:`ValueError` here, at
        ingestion — not later inside the service loop, where the failure
        would take every in-flight request down with it.
        """
        with self._vocab_lock:
            vocab_lib.check_compatible(self._state, delta_state)
            producer = (None if self._stream is None
                        else torch.cuda.current_stream(self.device))
            if self._pending_delta is None:
                self._pending_delta = delta_state
            else:
                if producer is not None:
                    producer.wait_event(self._pending_event)
                    _record_state(self._pending_delta, producer)
                self._pending_delta = vocab_lib.merge(self._pending_delta, delta_state)
            if producer is not None:
                self._pending_event = producer.record_event()
        self._c_refresh.add(1)
        obs.instant("vocab/refresh", cat="vocab")

    def _reader_waits(self) -> None:
        """Make the caller's current stream wait for the loop stream and the
        pending delta's producer (CUDA; call under ``_vocab_lock``)."""
        if self._stream is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self._stream)
        # The one caller (absorb) holds _vocab_lock here, which the lint cannot see.
        if self._pending_event is not None:  # locklint: ignore[LK402]
            current.wait_event(self._pending_event)  # locklint: ignore[LK402]

    def absorb(self, payload, row_offset: int | None = None) -> None:
        """Run loop ① on one payload and fold the delta into the serving
        vocabulary — the online half of the incremental refresh.

        :meth:`refresh_vocab` consumes loop-① states built *elsewhere*;
        ``absorb`` builds one *here*, executing the compiled plan's vocab
        half on the payload on the caller's current stream, and then
        folds it in via the same commutative-monoid :meth:`refresh_vocab`
        path (applied atomically between micro-batch steps).

        ``row_offset`` seeds the chunk's global first-occurrence
        positions. Default (None): the rows the service has already
        absorbed (merged state + pending deltas), i.e. sequential
        ingestion order; reading it waits for the device. Pass explicit
        offsets to replicate a specific offline row order bit-for-bit.
        Concurrent default-offset absorbs are serialized by an internal
        lock.

        Accepts the same payload formats as :meth:`submit`; one payload
        must fit the config's chunk geometry (``max_rows_per_chunk`` /
        ``chunk_bytes``) — slice bulk ingests into chunks first.
        """
        req = scheduler_lib.make_request(payload, self.config)
        cfg = self.config
        if req.n_rows > cfg.max_rows_per_chunk or (
            cfg.input_format == "utf8" and req.n_bytes > cfg.chunk_bytes
        ):
            raise ValueError(
                f"absorb payload of {req.n_rows} rows / {req.n_bytes} bytes "
                f"exceeds the chunk geometry ({cfg.max_rows_per_chunk} rows / "
                f"{cfg.chunk_bytes} bytes); slice bulk ingests into chunks"
            )
        with self._absorb_lock:
            if row_offset is None:
                with self._vocab_lock:
                    self._reader_waits()
                    pending = self._pending_delta
                    row_offset = int(self._state.rows_seen) + (
                        int(pending.rows_seen) if pending is not None else 0
                    )
            if row_offset + req.n_rows > vocab_lib.MAX_ROWS:
                raise OverflowError(
                    f"absorb would exceed the int32 position ceiling: "
                    f"row offset {row_offset} + {req.n_rows} rows > "
                    f"{vocab_lib.MAX_ROWS}"
                )
            chunk = padded_chunk(req, cfg)
            base = self._ingest.init_state()
            base = vocab_lib.VocabState(
                first_pos=base.first_pos,
                rows_seen=torch.full((), row_offset, dtype=torch.int32, device=self.device),
                counts=base.counts,
            )
            with obs.span("loop1/absorb", **self._ingest._vocab_span_labels):
                st = self._ingest.vocab_step(base, chunk)
            self._c_absorb.add(1)
            # the delta carries only ITS valid-row count: merge() sums
            # rows_seen, so the offset must not be double-counted (counts
            # started from zero, so they already are the delta's own)
            delta = vocab_lib.VocabState(
                first_pos=st.first_pos,
                rows_seen=st.rows_seen - row_offset,
                counts=st.counts,
            )
            self.refresh_vocab(delta)

    @property
    def vocab_state(self) -> vocab_lib.VocabState:
        """The service's current merged loop-① state (refresh deltas not
        yet applied by the loop are excluded), safe to read on the
        caller's current stream."""
        with self._vocab_lock:
            state = self._state
            if self._stream is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_stream(self._stream)
                _record_state(state, current)
            return state

    def compile_cache_size(self) -> int:
        return self.scheduler.compile_cache_size()

    def last_swap_seconds(self) -> float | None:
        """Device seconds of the last vocabulary swap (merge + finalize) on
        the loop stream, waiting for it to finish; None on the CPU or
        before any swap."""
        events = self._swap_events
        if events is None:
            return None
        events[1].synchronize()
        return events[0].elapsed_time(events[1]) / 1e3

    def stall_report(self) -> dict:
        """Where the service loop's wall time went: exhaustive split into
        queue-wait / host-assembly / device-dispatch / vocab-merge seconds
        (every loop second lands in exactly one bucket, so the buckets sum
        to the measured wall time — see :func:`repro_torch.obs.stall.report`)."""
        return stall_lib.report(self.registry)

    # ------------------------------------------------------------------ #
    # service loop
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        with self._on_stream():
            self._loop()

    def _loop(self) -> None:
        inflight: tuple | None = None  # (MicroBatch, ProcessedBatch)
        nxt: tuple | None = None
        gathered: list = []
        self._stall.start()
        try:
            while True:
                self._apply_pending_vocab()
                self._stall.lap("vocab_merge")
                # Only wait for ingress when idle: with a batch in flight
                # an empty queue means "complete it now", not "poll" —
                # polling would tax sparse-traffic latency by poll_s.
                if inflight is None:
                    with obs.span("queue/wait", cat="queue"):
                        gathered = self._gather(block=True)
                else:
                    gathered = self._gather(block=False)
                self._g_qdepth.set(self._ingress.qsize())
                self._stall.lap("queue_wait")
                # Cache consult happens HERE — in the loop thread, after
                # _apply_pending_vocab — so the vocab digest in every key
                # is exactly the vocabulary this step would dispatch with.
                # Hits complete immediately and fall out of the batch;
                # the time is charged to host_assembly via the next lap.
                gathered = self._consult_cache(gathered)
                nxt = None
                if gathered:
                    # With a batch in flight, this step's host work runs
                    # UNDER the device's compute — that hidden time is the
                    # double-buffering win, attributed to overlap_assembly_s.
                    overlapped = inflight is not None
                    t_host = time.perf_counter()
                    with obs.span(
                        "stream/assemble", cat="stream", requests=len(gathered)
                    ):
                        batch = self.scheduler.assemble(gathered)
                    self._stall.lap("host_assembly")
                    # asynchronous dispatch: the device starts on batch
                    # i+1's copy in and kernels while batch i is in flight
                    with obs.span(
                        "stream/dispatch", cat="stream", bucket_rows=batch.bucket.rows
                    ):
                        nxt = (batch, self.scheduler.dispatch(batch))
                    self._stall.lap("device_dispatch")
                    if overlapped:
                        self._c_overlap.add(time.perf_counter() - t_host)
                    gathered = []
                if inflight is not None:
                    with obs.span(
                        "device/wait",
                        cat="stream",
                        bucket_rows=inflight[0].bucket.rows,
                    ):
                        self._complete(*inflight)
                    self._stall.lap("device_dispatch")
                    inflight = None
                inflight = nxt
                nxt = None
                if (
                    inflight is None
                    and self._stop_evt.is_set()
                    and self._carry is None
                    and self._ingress.empty()
                ):
                    return
        except BaseException as e:  # noqa: BLE001 — fail requests, don't hang
            self._error = e
            self._stop_evt.set()  # new submits refuse; stop() is a no-op join
            doomed = list(gathered)
            for item in (inflight, nxt):
                if item is not None:
                    doomed.extend(item[0].requests)
            if self._carry is not None:
                doomed.append(self._carry)
                self._carry = None
            while True:
                try:
                    doomed.append(self._ingress.get_nowait())
                except queue.Empty:
                    break
            self._fail_requests(doomed, e)
        finally:
            # The tail segment (since the last lap) is idle waiting for
            # shutdown — charge it to queue_wait so Σ buckets == wall.
            self._stall.stop("queue_wait")

    def _fail_requests(self, requests, err: BaseException) -> None:
        if not requests:
            return
        for r in requests:
            r._fail(err)
        with self._cond:
            self._outstanding -= len(requests)
            self._cond.notify_all()

    def _apply_pending_vocab(self) -> None:
        # The pop AND the merge into _state must share one critical
        # section: a concurrent absorb(row_offset=None) computes its
        # offset as _state.rows_seen + _pending_delta.rows_seen, and in
        # the window between a popped delta and its merge that delta
        # would be counted by neither — undercounting the offset and
        # breaking the offline row-order guarantee. finalize + the
        # scheduler swap stay outside: only this thread writes _state.
        with self._vocab_lock:
            delta, self._pending_delta = self._pending_delta, None
            produced, self._pending_event = self._pending_event, None
            if delta is None:
                return
            t0 = time.perf_counter()
            if self._stream is not None:
                self._stream.wait_event(produced)
                _record_state(delta, self._stream)
                start = self._stream.record_event(torch.cuda.Event(enable_timing=True))
            with obs.span("vocab/merge", cat="vocab"):
                self._state = merged = vocab_lib.merge(self._state, delta)
        with obs.span("vocab/swap", cat="vocab"):
            vocabulary = self._finalizer(merged)
            self.scheduler.swap_vocabulary(vocabulary)
        if self._stream is not None:
            end = self._stream.record_event(torch.cuda.Event(enable_timing=True))
            self._swap_events = (start, end)
        self._h_swap.observe(time.perf_counter() - t0)
        if self.cache is not None:
            # New digest → new keys: entries under the superseded
            # vocabulary stop matching and age out of the LRU naturally.
            t0 = time.perf_counter()
            self._vocab_digest = chunk_cache_lib.vocab_digest(vocabulary)
            self._h_digest.observe(time.perf_counter() - t0)
        self._c_apply.add(1)
        obs.instant("vocab/applied", cat="vocab")

    def _consult_cache(self, reqs: list) -> list:
        """Complete cache hits immediately; return the misses.

        Loop-thread only: keys combine each request's client-computed raw
        digest with ``self._vocab_digest``, which only this thread
        updates (in :meth:`_apply_pending_vocab`) — so a key can never
        pair a payload with a vocabulary other than the one its batch
        would have used. Misses keep their key for the insert at
        :meth:`_complete`."""
        if self.cache is None or not reqs:
            return reqs
        misses: list = []
        hits: list = []
        for req in reqs:
            key = chunk_cache_lib.cache_key(
                req._raw_digest, self._plan_sig, self._vocab_digest
            )
            val = self.cache.get(key)
            if val is None:
                req._cache_key = key
                misses.append(req)
            else:
                hits.append((req, val))
        # Finish hits only after the full scan: if a lookup raises, no
        # request has been completed yet, so the loop's failure path can
        # still fail the whole gathered list exactly once.
        if hits:
            now = time.perf_counter()
            for req, val in hits:
                req.done_t = now
                self.metrics.record(now - req.submit_t, req.n_rows, now=now)
                # Hand out copies: the cache's storage must survive
                # whatever the consumer does with the result.
                req._finish({k: np.array(v) for k, v in val.items()})
            obs.instant("cache/hits", cat="stream", n=len(hits))
            with self._cond:
                self._outstanding -= len(hits)
                self._cond.notify_all()
        return misses

    def _gather(self, block: bool) -> list:
        """Coalesce queued requests FIFO up to the largest bucket.

        A request that would overflow the current batch is *carried* to
        the next step (FIFO order preserved — no starvation). ``block``
        waits up to ``poll_s`` for the first request; the loop passes
        False while a batch is in flight."""
        reqs: list = []
        rows = nbytes = 0
        if self._carry is not None:
            r, self._carry = self._carry, None
            reqs.append(r)
            rows, nbytes = r.n_rows, r.n_bytes
        while True:
            try:
                r = (
                    self._ingress.get(timeout=self._poll_s)
                    if block and not reqs
                    else self._ingress.get_nowait()
                )
            except queue.Empty:
                return reqs
            if self.scheduler.fits(rows, nbytes, r):
                reqs.append(r)
                rows += r.n_rows
                nbytes += r.n_bytes
            else:
                self._carry = r
                return reqs

    def _complete(self, batch, out) -> None:
        """Route one finished step back to its requests + record metrics.

        Latency is recorded *before* ``_finish`` unblocks the waiter, so
        a caller that resets ``metrics`` right after ``result()`` returns
        (e.g. :meth:`warmup`) can never lose or misplace a record."""
        results = self.scheduler.route(batch, out)
        now = time.perf_counter()
        for req, res in zip(batch.requests, results):
            if self.cache is not None:
                # Keyed at consult time, against the vocabulary this very
                # batch dispatched with — inserting after a later vocab
                # swap is still correct.
                self.cache.put(req._cache_key, res)
            req.done_t = now
            self.metrics.record(now - req.submit_t, req.n_rows, now=now)
            req._finish(res)
        with self._cond:
            self._outstanding -= len(batch.requests)
            self._cond.notify_all()
