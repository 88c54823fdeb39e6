"""Fixed-size training batches from Piper's output.

Counterpart of the batch assembly of ``repro/train/input_pipeline.py::
TrainInputPipeline`` in its ``overlap=False`` mode: batch k is rows
``[k·B, (k+1)·B)`` of the stream's valid rows, over ``FIELDS``, and the
source is invoked again whenever the stream runs dry, so the batch
sequence is a pure function of the source's output. It is fed an iterable
of the port's :class:`~repro_torch.core.schema.ProcessedBatch` (what
``PiperPipeline.run_stream`` yields) instead of the stream service, and
its batches stay on the device the source's tensors are on. The
service-fed bridge, device prefetching and the stall clock are not ported.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import torch

FIELDS = ("label", "dense", "sparse")


class TrainInputPipeline:
    """``n_steps`` batches of ``batch_rows`` rows, each a dict of
    ``FIELDS``.

    Args:
      source: a zero-argument callable returning a fresh iterable of
        ``ProcessedBatch`` (called once per epoch), or an iterable that is
        iterated again per epoch (a list or tuple).
      batch_rows: rows per batch; batches are consecutive slices of the
        valid rows.
      n_steps: batches the iterator yields.

    Taking a batch's valid rows reads how many there are, so each source
    batch costs one wait for the device.
    """

    def __init__(self, source: Callable[[], Iterable] | Iterable, *, batch_rows: int,
                 n_steps: int):
        if batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if callable(source):
            self._factory = source
        else:
            self._factory = lambda: iter(source)
        self.batch_rows = int(batch_rows)
        self.n_steps = int(n_steps)

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        bufs: dict[str, list[torch.Tensor]] = {k: [] for k in FIELDS}
        buffered = 0
        it = iter(self._factory())
        epoch_rows = 0
        produced = 0
        while produced < self.n_steps:
            if buffered < self.batch_rows:
                try:
                    out = next(it)
                except StopIteration:
                    if epoch_rows == 0:
                        raise ValueError(
                            "source produced no rows; cannot fill a batch of "
                            f"{self.batch_rows} rows"
                        ) from None
                    it = iter(self._factory())  # epoch boundary
                    epoch_rows = 0
                    continue
                for k in FIELDS:
                    bufs[k].append(getattr(out, k)[out.valid])
                n = int(bufs["label"][-1].shape[0])
                buffered += n
                epoch_rows += n
                continue
            cat = {k: v[0] if len(v) == 1 else torch.cat(v) for k, v in bufs.items()}
            batch = {k: cat[k][: self.batch_rows] for k in FIELDS}
            bufs = {k: [cat[k][self.batch_rows:]] for k in FIELDS}
            buffered -= self.batch_rows
            produced += 1
            yield batch
