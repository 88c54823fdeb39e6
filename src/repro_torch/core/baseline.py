"""Row-wise CPU baseline pipeline (paper Figure 3) and test oracle.

Counterpart of ``repro/core/baseline.py``, in numpy on the port's own
``core/schema.py``; it runs on the CPU by design. The paper's CPU baseline
partitions rows across threads; every thread runs the full operator chain
on its rows and builds a *sub-dictionary* for each sparse column, after
which a synchronization step merges the sub-dictionaries into the unified
vocabulary (the scaling bottleneck the paper measures in Figure 8):

  * ``split_input_file``   — SIF stage: count rows, partition into sub-files
  * ``decode_rows_serial`` — byte-serial decode (the 1 B/cycle state machine)
  * ``generate_vocab_thread`` / ``merge_sub_dictionaries`` — per-thread
    sub-dicts and their ordered merge (GV stage)
  * ``apply_vocab``        — shared-table mapping + dense transforms (AV)
  * ``concatenate``        — CFR stage

It is the independent oracle for the columnar engine: the "appearing
sequence" vocabulary ids produced here define correctness.
``decode_rows_serial`` is a byte-serial Python loop (about a second per
10^5-10^6 bytes), so keep oracle inputs small.

Configs (paper §4.2.1): Config I/II differ only in where intermediates
live (disk vs memory), with identical outputs; Config III consumes the
pre-decoded binary table (``run_pipeline(binary_input=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import schema as schema_lib


def split_input_file(buf: np.ndarray, n_threads: int) -> list[np.ndarray]:
    """SIF: count rows and partition the byte buffer row-wise into sub-files."""
    newline_pos = np.flatnonzero(buf == schema_lib.NEWLINE)
    n_rows = newline_pos.size
    bounds = [0] + [
        int(newline_pos[min(n_rows, (n_rows * (t + 1)) // n_threads) - 1]) + 1
        for t in range(n_threads)
    ]
    subs = []
    for t in range(n_threads):
        lo, hi = bounds[t], bounds[t + 1]
        if hi > lo:
            subs.append(buf[lo:hi].copy())
    return subs


def decode_rows_serial(
    buf: np.ndarray, schema: schema_lib.TableSchema
) -> dict[str, np.ndarray]:
    """Byte-serial decode — the reference state machine (paper Figure 6).

    Walks the buffer one byte at a time with a 32-bit register, exactly as
    the FPGA's baseline Decode PE: multiply-add for decimal, shift-or for
    hex, two's complement on the minus flag, reset at delimiters.
    """
    hex_field = schema.field_is_hex()
    n_fields = schema.n_fields
    rows: list[list[int]] = []
    field: list[int] = []
    reg = np.int32(0)
    neg = False
    for raw in buf.tolist():
        if raw == schema_lib.TAB or raw == schema_lib.NEWLINE:
            field.append(-int(reg) if neg else int(reg))
            reg = np.int32(0)
            neg = False
            if raw == schema_lib.NEWLINE:
                rows.append(field)
                field = []
        elif raw == schema_lib.MINUS:
            neg = True
        elif schema_lib.BYTE_0 <= raw <= schema_lib.BYTE_9:
            fidx = len(field) % n_fields
            base = np.int32(16 if hex_field[fidx] else 10)
            with np.errstate(over="ignore"):
                reg = np.int32(reg * base + np.int32(raw - schema_lib.BYTE_0))
        elif schema_lib.BYTE_A_LOWER <= raw <= schema_lib.BYTE_F_LOWER:
            with np.errstate(over="ignore"):
                reg = np.int32(reg * np.int32(16) + np.int32(raw - schema_lib.BYTE_A_LOWER + 10))
        # other bytes (zero padding) are inert

    if not rows:
        z = np.zeros((0,), np.int32)
        return {
            "label": z,
            "dense": z.reshape(0, schema.n_dense),
            "sparse": z.reshape(0, schema.n_sparse),
        }
    arr = np.asarray(rows, dtype=np.int64).astype(np.int32)
    return {
        "label": arr[:, 0],
        "dense": arr[:, schema.dense_slice],
        "sparse": arr[:, schema.sparse_slice],
    }


def positive_modulus(sparse: np.ndarray, vocab_range: int) -> np.ndarray:
    """Paper's Modulus op: hash values are unsigned; mod into [0, range)."""
    return (sparse.view(np.uint32) % np.uint32(vocab_range)).astype(np.int32)


@dataclasses.dataclass
class SubDictionary:
    """Per-thread GV state: appearing-order unique ids for one sparse column."""

    order: list[int]  # unique hashed values, in order of first appearance


def generate_vocab_thread(
    modded: np.ndarray, schema: schema_lib.TableSchema
) -> list[SubDictionary]:
    """GV step for one thread: collect appearing sequence per sparse column."""
    subs = []
    for c in range(schema.n_sparse):
        seen: dict[int, None] = {}
        for v in modded[:, c].tolist():
            if v not in seen:
                seen[v] = None
        subs.append(SubDictionary(order=list(seen.keys())))
    return subs


def merge_sub_dictionaries(
    per_thread: list[list[SubDictionary]], schema: schema_lib.TableSchema
) -> list[dict[int, int]]:
    """The synchronization step: merge thread sub-dicts in thread order.

    This is the stateful bottleneck the paper targets — merged sequentially
    because appearing-sequence ids depend on global row order.
    """
    vocab: list[dict[int, int]] = []
    for c in range(schema.n_sparse):
        table: dict[int, int] = {}
        for thread_subs in per_thread:
            for v in thread_subs[c].order:
                if v not in table:
                    table[v] = len(table)
        vocab.append(table)
    return vocab


def apply_vocab(
    decoded: dict[str, np.ndarray],
    vocab: list[dict[int, int]],
    schema: schema_lib.TableSchema,
) -> dict[str, np.ndarray]:
    """AV step: map sparse→vocab id, Neg2Zero + log1p on dense."""
    modded = positive_modulus(decoded["sparse"], schema.vocab_range)
    sparse_ids = np.empty_like(modded)
    for c in range(schema.n_sparse):
        table = vocab[c]
        sparse_ids[:, c] = np.asarray(
            [table[v] for v in modded[:, c].tolist()], dtype=np.int32
        )
    dense = decoded["dense"].astype(np.float64)
    dense = np.maximum(dense, 0.0)       # Neg2Zero
    dense = np.log1p(dense)              # Logarithm (log(x+1))
    return {
        "label": decoded["label"],
        "dense": dense.astype(np.float32),
        "sparse": sparse_ids,
    }


def concatenate(parts: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """CFR step: stitch per-thread results back into one row-ordered table."""
    return {
        k: np.concatenate([p[k] for p in parts], axis=0)
        for k in ("label", "dense", "sparse")
    }


def run_pipeline(
    buf: np.ndarray,
    schema: schema_lib.TableSchema,
    n_threads: int = 1,
    binary_input: dict[str, np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Full row-wise baseline pipeline (Config I/II structure).

    With ``binary_input`` set, runs the Config III path (no decode; the
    binary table is row-partitioned directly).
    """
    if binary_input is not None:
        rows = binary_input["label"].shape[0]
        per_thread_rows = [
            slice((rows * t) // n_threads, (rows * (t + 1)) // n_threads)
            for t in range(n_threads)
        ]
        decoded_parts = [
            {k: binary_input[k][s] for k in ("label", "dense", "sparse")}
            for s in per_thread_rows
        ]
    else:
        subs = split_input_file(buf, n_threads)
        decoded_parts = [decode_rows_serial(s, schema) for s in subs]

    per_thread_subdicts = [
        generate_vocab_thread(
            positive_modulus(p["sparse"], schema.vocab_range), schema
        )
        for p in decoded_parts
    ]
    vocab = merge_sub_dictionaries(per_thread_subdicts, schema)
    applied = [apply_vocab(p, vocab, schema) for p in decoded_parts]
    return concatenate(applied)
