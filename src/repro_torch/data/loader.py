"""Host data feeds.

Counterpart of ``repro/data/loader.py``, so far:
  * ``TokenBatches`` — deterministic synthetic LM token batches: the batch
    of step *i* is a function of (seed, i).
  * ``PiperTokenBatches`` — LM token windows over Piper's sparse ordinals,
    the preprocessing → LM handoff.
  * ``BinaryChunkFeed`` — the paper's Config III stacked feed that
    ``PiperPipeline.run_scan`` takes with ``input_format="binary"``.
The numpy logic is the reference's, so the same step gives the same
tokens in both packages.
"""

from __future__ import annotations

import numpy as np


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
