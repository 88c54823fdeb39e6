"""Host data feeds, prefetch and device staging.

Counterpart of ``repro/data/loader.py``:
  * ``TokenBatches`` — deterministic synthetic LM token batches: the batch
    of step *i* is a function of (seed, i).
  * ``PiperTokenBatches`` — LM token windows over Piper's sparse ordinals,
    the preprocessing → LM handoff.
  * ``TabularChunkFeed`` — row-framed utf8 byte chunks assigned
    round-robin to row shards, with global first-row offsets.
  * ``BinaryChunkFeed`` — the paper's Config III stacked feed that
    ``PiperPipeline.run_scan`` takes with ``input_format="binary"``.
  * ``Prefetcher`` — a background producer over a step-indexed
    ``batch_fn`` with a bounded queue.
  * ``DevicePrefetcher`` — a ``Prefetcher`` whose producer also stages
    each batch onto the card: a pinned host copy, then an asynchronous
    copy in on a CUDA stream of its own, ordered before the consumer's
    stream by an event.
The numpy logic is the reference's, so the same step gives the same
tokens and the same chunks in both packages.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import schema as schema_lib


class TokenBatches:
    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        return {
            "tokens": rng.integers(
                0, self.vocab_size, size=(self.batch, self.seq), dtype=np.int32
            )
        }


class PiperTokenBatches:
    """LM batches drawn from Piper-preprocessed tabular data.

    The vocabulary-encoded sparse ordinals of consecutive rows are
    concatenated into a token stream (ordinal space == LM vocab ids, taken
    modulo ``vocab_size``) and cut into fixed-length windows.
    """

    def __init__(self, processed_sparse: np.ndarray, vocab_size: int, batch: int, seq: int):
        stream = np.asarray(processed_sparse).reshape(-1).astype(np.int64) % vocab_size
        self.stream = stream.astype(np.int32)
        self.batch = batch
        self.seq = seq

    def __call__(self, step: int) -> dict:
        n = self.batch * self.seq
        start = (step * n) % max(len(self.stream) - n, 1)
        window = self.stream[start : start + n]
        if len(window) < n:
            window = np.pad(window, (0, n - len(window)), mode="wrap")
        return {"tokens": window.reshape(self.batch, self.seq)}


class TabularChunkFeed:
    """Distribute row-framed byte chunks across row shards with offsets.

    Chunk ``i`` is assigned round-robin to shard ``i % n_row_shards`` at
    step ``i // n_row_shards``; the tail is padded with all-zero chunks
    (zero rows, offset 0) so every shard sees the same step count. Each
    chunk carries its global first-row index (the newlines before it), so
    a sharded loop ① records the same first-occurrence positions as one
    pass over the whole feed.

    Two layouts over the same assignment: ``stacked``/``offsets`` are
    step-major ``[n_steps, n_shards, ...]`` (one chunk per shard a step),
    ``shard_stacks()`` is shard-major ``[n_shards, n_steps, ...]`` (one
    private stack per shard).
    """

    def __init__(self, buf: np.ndarray, chunk_bytes: int, n_row_shards: int):
        from repro_torch.data import synth

        chunks = list(synth.chunk_stream(buf, chunk_bytes))
        rows_per = [int((c == schema_lib.NEWLINE).sum()) for c in chunks]
        offsets = np.cumsum([0] + rows_per[:-1]).astype(np.int32)
        d = n_row_shards
        n_steps = (len(chunks) + d - 1) // d
        pad = n_steps * d - len(chunks)
        chunks += [np.zeros(chunk_bytes, np.uint8)] * pad
        offsets = np.concatenate([offsets, np.zeros(pad, np.int32)])
        self.stacked = np.stack(chunks).reshape(n_steps, d, chunk_bytes)
        self.offsets = offsets.reshape(n_steps, d)
        self.n_steps = n_steps
        self.n_shards = d
        self.chunk_bytes = chunk_bytes

    def shard_stacks(self) -> tuple[np.ndarray, np.ndarray]:
        """``(chunks uint8 [n_shards, n_steps, chunk_bytes], offsets int32
        [n_shards, n_steps])``: shard ``k``'s stack holds chunks ``k,
        k+n_shards, k+2·n_shards, …`` with their global row offsets."""
        return (
            np.ascontiguousarray(self.stacked.transpose(1, 0, 2)),
            np.ascontiguousarray(self.offsets.T),
        )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for i in range(self.n_steps):
            yield self.stacked[i], self.offsets[i]


class BinaryChunkFeed:
    """Pre-decoded rows sliced into fixed-row chunks.

    Slices a binary table (``{label, dense, sparse}`` int32 arrays, the
    output of ``synth.generate_binary``) into fixed-row chunks, assigned
    round-robin to row shards (chunk ``i`` → shard ``i % d``, step
    ``i // d``), with global first-row offsets. Tail rows of the last
    chunk and whole pad chunks carry ``valid=False``.
    """

    def __init__(self, table: dict, rows_per_chunk: int, n_row_shards: int = 1):
        rows = int(table["label"].shape[0])
        rpc = int(rows_per_chunk)
        d = int(n_row_shards)
        n_chunks = (rows + rpc - 1) // rpc
        self.n_steps = (n_chunks + d - 1) // d
        self.n_shards = d
        self.rows_per_chunk = rpc
        total = self.n_steps * d
        padded = total * rpc

        def pack(key):
            arr = np.asarray(table[key], dtype=np.int32)
            out = np.zeros((padded,) + arr.shape[1:], np.int32)
            out[:rows] = arr
            return out.reshape((self.n_steps, d, rpc) + arr.shape[1:])

        valid = (np.arange(padded) < rows).reshape(self.n_steps, d, rpc)
        self.stacked = {
            "label": pack("label"),
            "dense": pack("dense"),
            "sparse": pack("sparse"),
            "valid": valid,
        }
        self.offsets = np.minimum(np.arange(total) * rpc, rows).astype(
            np.int32
        ).reshape(self.n_steps, d)

    def flat_chunks(self) -> dict:
        """Chunk-order ``[n_steps*d, rows, ...]`` dict — the single-device
        ``PiperPipeline.run_scan`` feed (with ``input_format="binary"``)."""
        return {
            k: np.ascontiguousarray(v.reshape((-1,) + v.shape[2:]))
            for k, v in self.stacked.items()
        }

    def shard_stacks(self) -> tuple[dict, np.ndarray]:
        """Shard-major ``([n_shards, n_steps, rows, ...] dict, offsets)``."""
        chunks = {
            k: np.ascontiguousarray(np.swapaxes(v, 0, 1))
            for k, v in self.stacked.items()
        }
        return chunks, np.ascontiguousarray(self.offsets.T)


class Prefetcher:
    """Background-thread prefetch queue over any step-indexed ``batch_fn``.

    A ``batch_fn`` exception does not die silently with the daemon
    thread: it is kept and re-raised from the consumer's ``get()`` as a
    ``RuntimeError`` whose cause it is.
    """

    def __init__(self, batch_fn: Callable[[int], dict], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.batch_fn = batch_fn
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def start(self, start_step: int = 0):
        def _producer():
            step = start_step
            while not self._stop.is_set():
                try:
                    item = (step, self.batch_fn(step))
                except BaseException as e:  # noqa: BLE001 — surfaced in get()
                    self._error = e
                    self._stop.set()
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        step += 1
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=_producer, name="prefetcher", daemon=True)
        self._thread.start()
        return self

    def get(self, timeout: float | None = None) -> tuple[int, dict]:
        """Next ``(step, batch)``; re-raises a producer exception.

        ``timeout`` is a deadline: ``TimeoutError`` after that many seconds
        with no batch (None waits indefinitely, polling for the producer's
        death)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = 0.1
            if deadline is not None:
                wait = min(wait, max(deadline - time.monotonic(), 0.001))
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("Prefetcher batch_fn failed") from self._error
                if self._stop.is_set():
                    raise RuntimeError("Prefetcher stopped while get() waited") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError("Prefetcher.get timed out") from None

    def stop(self):
        """Stop the producer; safe to call more than once. The join waits
        at most a second: a producer blocked inside ``batch_fn`` is left to
        finish on its own (it is a daemon thread)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=1.0)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" raises when there is no card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to stage batches on the CPU"
        )
    return dev


class PinnedStager:
    """Copies host batches (dicts of numpy arrays) to a device.

    On CUDA each batch goes into one of ``slots`` pinned host buffers, used
    in turn, and is copied in asynchronously on the caller's current
    stream; an event recorded behind the copies says when the slot may be
    written again, and :meth:`stage` waits on it before it reuses the slot.
    On the CPU a batch becomes tensors over its own copy of the arrays.
    """

    def __init__(self, device, slots: int):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self._slots: list[dict] = [{} for _ in range(slots)]
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._turn = 0

    def stage(self, batch: dict) -> tuple[dict, torch.cuda.Event | None]:
        """``(device batch, event behind its copies)``; the event is None on
        the CPU."""
        if not self.cuda:
            return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}, None
        i = self._turn
        self._turn = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()  # the slot's last copy has been read
        slot, out = self._slots[i], {}
        for k, v in batch.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            buf = slot.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = slot[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            out[k] = buf.to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.current_stream(self.device).record_event()
        return out, self._events[i]

    def pinned_buffers(self) -> int:
        """Pinned host buffers made so far (one per slot and field)."""
        return sum(len(s) for s in self._slots)


class DevicePrefetcher(Prefetcher):
    """Depth-N device-side prefetch: a :class:`Prefetcher` whose producer
    thread also stages each batch onto ``device``.

    On CUDA the producer owns one stream: it copies each host batch into a
    pinned buffer of its own (``depth + 2`` slots, so a slot is rewritten
    only after its copy finished, see :class:`PinnedStager`), issues the
    copies in on that stream and enqueues the batch with the event behind
    them. :meth:`get` makes the caller's current stream wait on that event
    and marks each tensor as used on it (``record_stream``), so the caching
    allocator does not hand the memory out before the caller's work on it
    is done. ``depth`` bounds how many staged batches may wait on the card.
    With ``device="cpu"`` a batch is tensors over its own copy, with no
    stream and no event. The default device is the card; without one the
    constructor raises.

    Inherits the Prefetcher contract: in-order ``(step, batch)`` pairs,
    ``batch_fn`` exceptions re-raised from ``get()``, idempotent ``stop()``.
    """

    def __init__(self, batch_fn: Callable[[int], dict], depth: int = 2, device="cuda"):
        def staged(step: int):
            host = batch_fn(step)
            if self._stream is None:
                return self.stager.stage(host)
            with torch.cuda.stream(self._stream):
                return self.stager.stage(host)

        super().__init__(staged, depth=depth)
        self.stager = PinnedStager(device, slots=depth + 2)
        self.device = self.stager.device
        self._stream = torch.cuda.Stream(self.device) if self.stager.cuda else None

    def get(self, timeout: float | None = None) -> tuple[int, dict]:
        step, (batch, event) = super().get(timeout)
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return step, batch
