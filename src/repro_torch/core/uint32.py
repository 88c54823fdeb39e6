"""uint32 arithmetic on int64 tensors.

The JAX package does its hash modulus, saturating positions and
``hash_cross`` in uint32. PyTorch on the CPU has no uint32 ``%``, ``>>``
or ``minimum``, so the port holds each uint32 value in an int64 tensor,
in ``[0, 2**32)``, and masks every result back to 32 bits. A product of
two such values may overflow int64; it wraps, and its low 32 bits are
still the uint32 product's.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) tensor → int64 holding its uint32 view."""
    return x.to(torch.int64) & MASK32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 tensor → int32 with the same low 32 bits (the bitcast of the
    uint32 value back to int32)."""
    u = u & MASK32
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
