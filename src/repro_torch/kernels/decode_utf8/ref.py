"""Plain PyTorch version of the parallel UTF-8 tabular decoder.

Counterpart of ``repro/kernels/decode_utf8/ref.py``. The per-byte update

    dense (decimal) digit:  v ← v*10 + d
    sparse (hex)    digit:  v ← v*16 + d

composes affine maps ``x ↦ m*x + a``, an associative operation, so the
decode is one *segmented* scan over the bytes, reset at delimiters. It
runs here as a Hillis–Steele scan (log₂ n vectorised steps) in uint32
held in int64 (core/uint32.py), which wraps exactly like the reference's
int32 register.

  * ``\\t`` and ``\\n`` both delimit; ``\\n`` additionally ends a row.
  * empty fields decode to 0 (FillMissing folded into Decode).
  * digits are ``0-9`` and ``a-f`` in every field; the field's base is 16
    for hexadecimal columns and 10 otherwise; a minus anywhere in a field
    negates it; every other byte is inert.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import schema as schema_lib
from repro_torch.core.uint32 import MASK32, to_i32


def _shift(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """``x`` shifted right by ``d`` places, ``fill`` coming in."""
    out = torch.full_like(x, fill)
    if d < x.shape[0]:
        out[d:] = x[:-d]
    return out


def _segmented_scan(m, a, neg, rst):
    """Inclusive segmented scan of affine elements:

    combine(L, R) = R                                  if R.reset
                  = (L.m·R.m, L.a·R.m + R.a, L.neg|R.neg) otherwise
    """
    d = 1
    while d < m.shape[0]:
        lm, la = _shift(m, d, 1), _shift(a, d, 0)
        lneg, lrst = _shift(neg, d, 0), _shift(rst, d, 0)
        blocked = rst == 1
        m, a, neg, rst = (
            torch.where(blocked, m, (lm * m) & MASK32),
            torch.where(blocked, a, (la * m + a) & MASK32),
            torch.where(blocked, neg, lneg | neg),
            rst | lrst,
        )
        d *= 2
    return a, neg


def decode_bytes(
    byte_buf: torch.Tensor,
    hex_field_table,
    *,
    n_fields: int,
    max_rows: int,
    n_dense: int,
    n_sparse: int,
):
    """Decode a padded byte buffer into a field table.

    Args:
      byte_buf: uint8 [B] — whole rows (each ``\\n``-terminated) + zero padding.
      hex_field_table: bool [n_fields] (numpy or torch) — hexadecimal columns.
      max_rows: output row capacity; rows past it are dropped.

    Returns:
      (label int32 [max_rows], dense int32 [max_rows, n_dense],
       sparse int32 [max_rows, n_sparse], valid bool [max_rows])
    """
    dev = byte_buf.device
    b = byte_buf.to(torch.int64)
    is_delim = (b == schema_lib.TAB) | (b == schema_lib.NEWLINE)
    delim = is_delim.to(torch.int64)
    # Exclusive cumsum of delimiters gives each byte its field ordinal.
    ordinal = torch.cumsum(delim, 0) - delim
    if not isinstance(hex_field_table, torch.Tensor):
        hex_field_table = torch.from_numpy(np.asarray(hex_field_table, dtype=bool))
    hex_table = hex_field_table.to(device=dev, dtype=torch.bool)
    base = torch.where(hex_table[ordinal % n_fields], 16, 10)

    is_dec = (b >= schema_lib.BYTE_0) & (b <= schema_lib.BYTE_9)
    is_hexa = (b >= schema_lib.BYTE_A_LOWER) & (b <= schema_lib.BYTE_F_LOWER)
    digit = torch.where(is_dec, b - schema_lib.BYTE_0, 0) + torch.where(
        is_hexa, b - schema_lib.BYTE_A_LOWER + 10, 0
    )
    is_digit = is_dec | is_hexa
    a, neg = _segmented_scan(
        torch.where(is_digit, base, 1),
        torch.where(is_digit, digit, 0),
        (b == schema_lib.MINUS).to(torch.int64),
        delim,
    )
    # The value a delimiter completes is the scan value of the byte before it.
    prev_a = _shift(a, 1, 0)
    prev_neg = _shift(neg, 1, 0)
    value = to_i32(torch.where(prev_neg == 1, -prev_a, prev_a))

    row = ordinal // n_fields
    col = ordinal % n_fields
    keep = is_delim & (row < max_rows)
    out = torch.zeros((max_rows, n_fields), dtype=torch.int32, device=dev)
    out[row[keep], col[keep]] = value[keep]

    n_rows = (b == schema_lib.NEWLINE).sum()
    valid = torch.arange(max_rows, device=dev) < n_rows
    label = out[:, 0].contiguous()
    dense = out[:, 1 : 1 + n_dense].contiguous()
    sparse = out[:, 1 + n_dense : 1 + n_dense + n_sparse].contiguous()
    return label, dense, sparse, valid
