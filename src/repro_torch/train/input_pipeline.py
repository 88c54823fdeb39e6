"""Training input: the streaming service → fixed-size batches on the card.

Counterpart of ``repro/train/input_pipeline.py``. It drives DLRM training
straight from the streaming preprocessing service, and attributes every
second the trainer waits on input:

    raw payloads ──submit──▶ StreamingPreprocessService (loop ②, micro-
      │                        batched, optionally ChunkCache-fronted)
      │ host numpy results, in submission order
      ▼
    host assembly: concatenate the rows → fixed [batch_rows] slices
      (batch k is always rows [k·B, (k+1)·B) of the stream, so the batch
      sequence is a function of the payload sequence alone: overlap and
      caching cannot change a trained weight)
      ▼
    loader.DevicePrefetcher: a pinned copy, then the copy in on the
      prefetcher's own CUDA stream while the train step of an earlier
      batch runs; the trainer's stream waits on the copy's event
      ▼
    iterator → trainer (tensors on the card)

The service hands back host numpy (``stream/scheduler.py::route``), so a
batch goes card → pinned host → concatenate → pinned → card, as in the
reference.

``overlap=False`` runs the same assembly and staging synchronously inside
``next()`` on the trainer's stream (the materialise-then-train baseline),
so overlap on and off are an A/B of the same work.

Attribution: the iterator laps a :class:`repro_torch.obs.stall.StallClock`
around every yield, splitting the consumer loop's wall time into
``input_wait`` (blocked in ``next()``) and ``train_step`` (time the
caller held the batch); :meth:`TrainInputPipeline.stall_report` is the
snapshot, beside the ``e2e.batches_total`` / ``e2e.rows_total`` /
``e2e.epochs_total`` counters in the same registry.

:func:`stream_batches` is the same fixed-size assembly over the offline
engine's output (``PiperPipeline.run_stream``'s ``ProcessedBatch``es),
with no service, thread or staging.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data import loader as loader_lib
from repro_torch.obs import stall as stall_lib

FIELDS = ("label", "dense", "sparse")


def _factory(source: Callable[[], Iterable] | Iterable) -> Callable[[], Iterable]:
    """A zero-argument callable returning a fresh iterable: ``source``
    itself, or one that iterates ``source`` (a list or tuple) again."""
    if callable(source):
        return source
    return lambda: iter(source)


def _check_sizes(batch_rows: int, n_steps: int) -> None:
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")


class TrainInputPipeline:
    """Pulls preprocessed micro-batches from the stream service and yields
    fixed-shape batches on ``device``.

    Args:
      service: a started :class:`~repro_torch.stream.StreamingPreprocessService`,
        with or without a chunk cache.
      payload_factory: a zero-argument callable returning a fresh iterable
        of raw payloads (what the service's ``input_format`` accepts),
        called once per epoch: when the stream runs dry and batches are
        still owed, it is called again. A list or tuple also works.
      batch_rows: rows per training batch; batches are consecutive row
        slices of the preprocessed stream.
      n_steps: batches the iterator yields.
      overlap: True — assemble and stage in a background
        :class:`~repro_torch.data.loader.DevicePrefetcher`; False — the
        same work synchronously inside ``next()``.
      prefetch_depth: staged batches that may wait (overlap mode).
      inflight: service requests kept pending ahead of assembly.
      device: where the batches go; the card by default, which raises
        without one.
      registry: where the stall clock and counters land (default: a
        private one).
    """

    def __init__(
        self,
        service,
        payload_factory: Callable[[], Iterable] | Iterable,
        *,
        batch_rows: int,
        n_steps: int,
        overlap: bool = True,
        prefetch_depth: int = 2,
        inflight: int = 2,
        device="cuda",
        registry: obs.Registry | None = None,
    ):
        _check_sizes(batch_rows, n_steps)
        self.device = loader_lib.resolve_device(device)
        self.service = service
        self._factory = _factory(payload_factory)
        self.batch_rows = int(batch_rows)
        self.n_steps = int(n_steps)
        self.overlap = bool(overlap)
        self.prefetch_depth = int(prefetch_depth)
        self.inflight = max(1, int(inflight))
        self.registry = registry if registry is not None else obs.Registry()
        self._c_batches = self.registry.counter(
            "e2e.batches_total", "training batches produced by the input bridge"
        )
        self._c_rows = self.registry.counter(
            "e2e.rows_total", "preprocessed rows delivered to training"
        )
        self._c_epochs = self.registry.counter(
            "e2e.epochs_total", "payload-stream passes started"
        )

    def _host_batches(self) -> Iterator[dict]:
        """Exactly ``n_steps`` host batches of ``batch_rows`` rows.

        Keeps ``inflight`` service requests pending, so the service's
        double-buffered loop always has a next batch; results are consumed
        strictly in submission order, which pins the batch sequence."""
        bufs: dict[str, list[np.ndarray]] = {k: [] for k in FIELDS}
        buffered = 0
        pending: collections.deque = collections.deque()
        it = iter(self._factory())
        self._c_epochs.add(1)
        produced = 0
        exhausted = False
        while produced < self.n_steps:
            if buffered < self.batch_rows:
                while not exhausted and len(pending) < self.inflight:
                    try:
                        payload = next(it)
                    except StopIteration:
                        it = iter(self._factory())  # epoch boundary
                        self._c_epochs.add(1)
                        try:
                            payload = next(it)
                        except StopIteration:
                            exhausted = True  # the factory yields nothing
                            break
                    pending.append(self.service.submit(payload))
                if not pending:
                    raise ValueError(
                        "payload factory produced no payloads; cannot fill a "
                        f"batch of {self.batch_rows} rows"
                    )
                res = pending.popleft().result()
                for k in FIELDS:
                    bufs[k].append(res[k])
                buffered += int(res["label"].shape[0])
                continue
            cat = {k: v[0] if len(v) == 1 else np.concatenate(v) for k, v in bufs.items()}
            batch = {k: np.ascontiguousarray(cat[k][: self.batch_rows]) for k in FIELDS}
            bufs = {k: [cat[k][self.batch_rows:]] for k in FIELDS}
            buffered -= self.batch_rows
            produced += 1
            self._c_batches.add(1)
            self._c_rows.add(self.batch_rows)
            yield batch

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        """Yield ``n_steps`` batches on the device, lapping the e2e stall
        clock around each yield."""
        gen = self._host_batches()
        clock = stall_lib.StallClock(
            self.registry, buckets=stall_lib.E2E_BUCKETS, prefix=stall_lib.E2E_PREFIX
        )
        prefetcher = None
        if self.overlap:
            prefetcher = loader_lib.DevicePrefetcher(
                lambda step: next(gen), depth=self.prefetch_depth, device=self.device
            ).start()
            fetch = lambda: prefetcher.get()[1]  # noqa: E731
        else:
            # on the trainer's stream: the train step is queued behind the copy
            stager = loader_lib.PinnedStager(self.device, slots=2)
            fetch = lambda: stager.stage(next(gen))[0]  # noqa: E731
        clock.start()
        try:
            for _ in range(self.n_steps):
                with obs.span("e2e/input_wait", cat="e2e"):
                    batch = fetch()
                clock.lap("input_wait")
                yield batch
                clock.lap("train_step")
        finally:
            clock.stop("train_step")
            if prefetcher is not None:
                prefetcher.stop()

    def stall_report(self) -> dict:
        """Where the consumer loop's wall time went: the ``input_wait`` /
        ``train_step`` split (fractions and seconds)."""
        return stall_lib.report(
            self.registry, prefix=stall_lib.E2E_PREFIX, buckets=stall_lib.E2E_BUCKETS
        )


def stream_batches(source: Callable[[], Iterable] | Iterable, *, batch_rows: int,
                   n_steps: int) -> Iterator[dict[str, torch.Tensor]]:
    """``n_steps`` batches of ``batch_rows`` rows, each a dict of ``FIELDS``,
    from the offline engine's output.

    ``source`` is a zero-argument callable returning a fresh iterable of
    :class:`~repro_torch.core.schema.ProcessedBatch` (called once per
    epoch), or an iterable that is iterated again per epoch (a list or
    tuple). Batch k is rows ``[k·B, (k+1)·B)`` of the valid rows, as
    :class:`TrainInputPipeline`'s, and stays on the device the source's
    tensors are on. Taking a batch's valid rows reads how many there are,
    so each source batch costs one wait for the device.
    """
    _check_sizes(batch_rows, n_steps)
    return _stream_batches(_factory(source), batch_rows, n_steps)


def _stream_batches(factory, batch_rows: int, n_steps: int) -> Iterator[dict[str, torch.Tensor]]:
    bufs: dict[str, list[torch.Tensor]] = {k: [] for k in FIELDS}
    buffered = 0
    it = iter(factory())
    epoch_rows = 0
    produced = 0
    while produced < n_steps:
        if buffered < batch_rows:
            try:
                out = next(it)
            except StopIteration:
                if epoch_rows == 0:
                    raise ValueError(
                        "source produced no rows; cannot fill a batch of "
                        f"{batch_rows} rows"
                    ) from None
                it = iter(factory())  # epoch boundary
                epoch_rows = 0
                continue
            for k in FIELDS:
                bufs[k].append(getattr(out, k)[out.valid])
            n = int(bufs["label"][-1].shape[0])
            buffered += n
            epoch_rows += n
            continue
        cat = {k: v[0] if len(v) == 1 else torch.cat(v) for k, v in bufs.items()}
        batch = {k: cat[k][:batch_rows] for k in FIELDS}
        bufs = {k: [cat[k][batch_rows:]] for k in FIELDS}
        buffered -= batch_rows
        produced += 1
        yield batch
