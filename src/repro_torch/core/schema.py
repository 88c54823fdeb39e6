"""Tabular schema for the PIPER preprocessing pipeline.

The paper's workload (Criteo Kaggle / Meta DLRM) is a fixed-width-schema,
variable-width-encoding table: every row is

    label \\t d1 \\t ... \\t d13 \\t s1 \\t ... \\t s26 \\n

where ``label``/``d*`` are signed decimal integers (dense features) and
``s*`` are unsigned hexadecimal hash strings (sparse features). Empty
fields decode to 0 (FillMissing is folded into Decode).

Counterpart of ``repro/core/schema.py``; the batches are plain
dataclasses of torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --- byte constants -------------------------------------------------------
TAB = 0x09        # field delimiter
NEWLINE = 0x0A    # row delimiter
MINUS = 0x2D      # sign for dense (decimal) fields
BYTE_0, BYTE_9 = 0x30, 0x39
BYTE_A_LOWER, BYTE_F_LOWER = 0x61, 0x66


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Column layout of a PIPER table.

    Field order on the wire is: 1 label, then ``n_dense`` decimal columns,
    then ``n_sparse`` hexadecimal columns — exactly the Criteo layout when
    ``n_dense=13, n_sparse=26``.
    """

    n_dense: int = 13
    n_sparse: int = 26
    # Modulus range for sparse features == embedding-table row count.
    # The paper evaluates 5K and 1M.
    vocab_range: int = 5000
    # Maximum encoded width of one row in bytes.
    max_row_bytes: int = 640

    @property
    def n_fields(self) -> int:
        """Fields per row, label included."""
        return 1 + self.n_dense + self.n_sparse

    @property
    def dense_slice(self) -> slice:
        return slice(1, 1 + self.n_dense)

    @property
    def sparse_slice(self) -> slice:
        return slice(1 + self.n_dense, self.n_fields)

    def field_is_hex(self) -> np.ndarray:
        """Bool[n_fields]: True for hexadecimal (sparse) columns."""
        flags = np.zeros(self.n_fields, dtype=bool)
        flags[self.sparse_slice] = True
        return flags


# The paper's exact evaluation schema (Criteo Kaggle), at both vocab ranges.
CRITEO = TableSchema(n_dense=13, n_sparse=26, vocab_range=5000)
CRITEO_1M = TableSchema(n_dense=13, n_sparse=26, vocab_range=1_000_000)


@dataclasses.dataclass
class TabularBatch:
    """Decoded (binary) representation of a chunk of rows.

    ``label``  int32 [rows]
    ``dense``  int32 [rows, n_dense]      (raw decoded integers, pre-transform)
    ``sparse`` int32 [rows, n_sparse]     (raw hashed ids, pre-modulus)
    ``valid``  bool  [rows]               (False for padding rows)
    """

    label: torch.Tensor
    dense: torch.Tensor
    sparse: torch.Tensor
    valid: torch.Tensor

    @property
    def rows(self) -> int:
        return int(self.label.shape[0])


@dataclasses.dataclass
class ProcessedBatch:
    """Output of the full pipeline — what the trainer consumes.

    ``dense``  float32 [rows, n_dense]    (Neg2Zero + log1p applied)
    ``sparse`` int32   [rows, n_sparse]   (vocabulary-encoded ordinals)
    """

    label: torch.Tensor
    dense: torch.Tensor
    sparse: torch.Tensor
    valid: torch.Tensor
