"""Device state that kernels of several libraries share, one per (device,
stream).

Launches on one stream run one after another, and launches on two streams
never share an entry, so each entry needs no fill between calls:

- :func:`tally` — the 64-bit row tally of the GenVocab kernels
  (csrc/genvocab_warp.cuh: ``fused_vocab.cu`` and ``vocab.cu``). Their
  blocks count the valid rows into it, and the last block puts it back
  to 0.
- :func:`scan_call` — the look-back scratch of the kernels on
  csrc/decode_tiles.cuh (``decode_utf8.cu``, ``fused_decode_xform.cu`` and
  ``fused_decode_vocab.cu``), whose ``next_epoch`` gives the call's epoch,
  which the kernel writes into every status word. A call of any of them
  takes the next epoch. A
  CUDA graph would replay one epoch forever, so all three refuse to be
  captured.
- :func:`pending` — the pending list of ``fused_decode_vocab.cu``: its
  counts, which the tile that finishes last puts back to 0, and the cells
  that the kernel's tiles could not yet scatter.

Several host threads may launch at once (the streaming service's loop
thread and the callers of its ``absorb``). Each entry is made (or, when it
is missing or too small, looked up again) under one lock, and a scan's caller takes its epoch and launches under its
scratch's own lock (``with scratch.lock:``), so two threads on one stream
can neither share an epoch nor launch out of epoch order. :func:`made_here`
counts the entries the calling thread has made or regrown: device memory
allocated on a call's path, which the streaming scheduler counts with its
batches' input shapes (``MicroBatchScheduler.compile_cache_size``).
"""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import _build

# The high half of a status word holds epoch << 2 | flag.
EPOCH_LIMIT = 1 << 30

Key = tuple[torch.device, int]

_lock = threading.Lock()  # guards the making of every entry below
_here = threading.local()  # .made: entries made or regrown by this thread


def _key(device: torch.device, stream: int) -> Key:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, stream


def _made() -> None:
    """Count one entry made or regrown by the calling thread."""
    _here.made = made_here() + 1


def made_here() -> int:
    """Entries (tally, pending list, look-back scratch) the calling thread
    has made or regrown so far, for launches on any stream."""
    return getattr(_here, "made", 0)


_tallies: dict[Key, torch.Tensor] = {}


def tally(device: torch.device, stream: int) -> torch.Tensor:
    """The int64 [1] row tally for launches on ``stream`` (a stream handle)
    of ``device``: made zeroed at first use, then kept, and left at 0 by
    every launch."""
    key = _key(device, stream)
    t = _tallies.get(key)  # entries are replaced, never changed: no lock to read
    if t is not None:
        return t
    with _lock:
        t = _tallies.get(key)
        if t is None:
            t = _tallies[key] = torch.zeros(1, dtype=torch.int64, device=key[0])
            _made()
        return t


_pendings: dict[Key, torch.Tensor] = {}


def pending(device: torch.device, stream: int, ints: int) -> torch.Tensor:
    """The int32 pending list for launches on ``stream`` (a stream handle)
    of ``device``, at least ``ints`` words: made zeroed at first use and
    when a call needs more, then kept, and left with its counts at 0 by
    every launch."""
    key = _key(device, stream)
    t = _pendings.get(key)
    if t is not None and t.numel() >= ints:
        return t
    with _lock:
        t = _pendings.get(key)
        if t is None or t.numel() < ints:
            t = _pendings[key] = torch.zeros(ints, dtype=torch.int32, device=key[0])
            _made()
        return t


class ScanScratch:
    """The look-back scratch of the launches on one stream: int32 words,
    zeroed when made, the epoch of the last call, and the lock under which
    a call takes its epoch and launches."""

    def __init__(self, ints: int, device: torch.device):
        self.words = torch.zeros(ints, dtype=torch.int32, device=device)
        self.epoch = 0
        self.lock = threading.RLock()

    def next_epoch(self) -> int:
        """The next call's epoch, in [1, EPOCH_LIMIT). When the epochs run
        out, the words are zeroed (on the current stream, so after every
        launch that used them) and the count starts again at 1: a word of
        an earlier call could otherwise carry a reused epoch."""
        with self.lock:
            self.epoch += 1
            if self.epoch >= EPOCH_LIMIT:
                self.words.zero_()
                self.epoch = 1
            return self.epoch


_scratches: dict[Key, ScanScratch] = {}


def scan_scratch(device: torch.device, stream: int, ints: int) -> ScanScratch:
    """The scratch for launches on ``stream`` (a stream handle) of
    ``device``, at least ``ints`` words: kept from the last call, or made
    anew (zeroed, epochs from 1) at first use and when a chunk needs more
    tiles than it holds."""
    key = _key(device, stream)
    s = _scratches.get(key)
    if s is not None and s.words.numel() >= ints:
        return s
    with _lock:
        s = _scratches.get(key)
        if s is None or s.words.numel() < ints:
            s = _scratches[key] = ScanScratch(ints, key[0])
            _made()
        return s


@functools.cache
def _scratch_ints_fn():
    fn = _build.library("decode_utf8").decode_scan_scratch_ints
    fn.argtypes = [_build.INT64]
    fn.restype = _build.INT64
    return fn


def scratch_ints(n: int) -> int:
    """The scratch words a call on an ``n``-byte chunk needs, from the
    decode library, which exports the count for its tile size."""
    return _scratch_ints_fn()(n)


def scan_call(device: torch.device, n: int, what: str) -> ScanScratch:
    """The look-back scratch of one launch on an ``n``-byte chunk on
    ``device``'s current stream. The caller takes the epoch and launches
    under ``scratch.lock``, so launches on one stream take their epochs in
    launch order. Raises under CUDA graph capture: a replay would reuse
    the epoch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} cannot be captured in a CUDA graph: each call needs a new "
            "epoch for its look-back scratch, and a replay would reuse one"
        )
    stream = torch.cuda.current_stream(device).cuda_stream
    return scan_scratch(device, stream, scratch_ints(n))
