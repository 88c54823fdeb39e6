"""Stateless PIPER operators (paper Table 1) and the fused-chain dispatchers.

Counterpart of ``repro/core/ops.py``. Each operator is a plain function on
tensors, on whatever device its input lies. ``fused_transform`` runs the
whole loop-② chain and ``fused_vocab_update`` the whole loop-① chain as
one kernel launch (kernels/fused_xform, kernels/fused_vocab);
``fused_decode_transform`` and ``fused_decode_vocab_update`` run each loop
from raw UTF-8 bytes, decode included, as one launch
(kernels/fused_decode_xform, kernels/fused_decode_vocab). With
``use_kernel=False`` the unfused operators below compose instead — the
differential oracle. ``apply_vocab`` and ``dense_transform`` dispatch to
the per-op kernels (kernels/vocab, kernels/dense_xform) with
``use_kernel=True``. ``Decode`` and ``FillMissing`` live in
kernels/decode_utf8.
"""

from __future__ import annotations

import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.core.uint32 import MASK32, as_u32, to_i32


def positive_modulus(sparse: torch.Tensor, vocab_range: int) -> torch.Tensor:
    """Modulus: map unsigned 32-bit hashes (stored as int32 bitcasts) into
    [0, vocab_range)."""
    return (as_u32(sparse) % int(vocab_range)).to(torch.int32)


def neg2zero(dense: torch.Tensor) -> torch.Tensor:
    """Neg2Zero: clamp negative dense features to zero."""
    return torch.clamp(dense, min=0)


def logarithm(dense: torch.Tensor) -> torch.Tensor:
    """Logarithm: log(x+1) on dense features, in f32."""
    return torch.log1p(dense.to(torch.float32))


def clip(dense: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip: clamp dense features to ``[lo, hi]`` (f32)."""
    return torch.clamp(dense.to(torch.float32), lo, hi)


def minmax_scale(dense: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """MinMaxScale: clip to ``[lo, hi]``, rescale to ``[0, 1]``."""
    return (clip(dense, lo, hi) - lo) / (hi - lo)


def bucketize(dense: torch.Tensor, boundaries: tuple[float, ...]) -> torch.Tensor:
    """Bucketize: value → f32 bucket index against strictly-increasing
    ``boundaries``; ``x == boundary`` lands in the upper bucket."""
    edges = torch.tensor(boundaries, dtype=torch.float32, device=dense.device)
    x = dense.to(torch.float32).contiguous()
    return torch.searchsorted(edges, x, right=True).to(torch.float32)


def hash_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HashCross: Murmur3-style mix of two raw sparse hash columns into one
    int32-bitcast hash column (uint32 math on int64, see core/uint32.py)."""
    ua, ub = as_u32(a), as_u32(b)
    h = (ua * 0x85EBCA6B) & MASK32
    rot = ((ub << 13) | (ub >> 19)) & MASK32  # rotl(b, 13)
    h = h ^ rot
    h = (h * 0xC2B2AE35) & MASK32
    h = h ^ (h >> 16)
    return to_i32(h)


def dense_transform(dense: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Neg2Zero + Logarithm. With ``use_kernel`` it is one launch of
    kernels/dense_xform (the plain version for CPU tensors)."""
    if use_kernel:
        from repro_torch.kernels.dense_xform import ops as dx_ops

        return dx_ops.dense_transform(dense)
    return logarithm(neg2zero(dense.to(torch.float32)))


def apply_vocab(
    vocab: vocab_lib.Vocabulary, modded: torch.Tensor, use_kernel: bool = False
) -> torch.Tensor:
    """ApplyVocab-2: gather through the finalized table. With
    ``use_kernel`` it is one launch of kernels/vocab at any vocab range
    (the plain version for CPU tensors); the reference keeps ranges above
    its VMEM cutoff on the plain gather."""
    if use_kernel:
        from repro_torch.kernels.vocab import ops as vocab_ops

        return vocab_ops.apply_vocab(vocab.table, modded)
    return vocab_lib.lookup(vocab, modded)


def fused_transform(
    vocab: vocab_lib.Vocabulary,
    sparse: torch.Tensor,
    dense: torch.Tensor,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole loop-② chain — Modulus → ApplyVocab ∥ Neg2Zero → Logarithm.

    With ``use_kernel`` it is one launch of kernels/fused_xform (the plain
    version for CPU tensors); without, the unfused operators compose.

    sparse int32 [rows, n_sparse] (raw hash bitcasts); dense int32
    [rows, n_dense] → (ids int32 [rows, n_sparse], dense f32 [rows, n_dense]).
    """
    if use_kernel:
        from repro_torch.kernels.fused_xform import ops as fx_ops

        return fx_ops.fused_transform(vocab, sparse, dense)
    modded = positive_modulus(sparse, vocab.vocab_range)
    return apply_vocab(vocab, modded), dense_transform(dense)


def fused_vocab_update(
    state: vocab_lib.VocabState,
    sparse: torch.Tensor,
    valid: torch.Tensor,
    use_kernel: bool = True,
) -> vocab_lib.VocabState:
    """Whole loop-① chain — Modulus → GenVocab scatter-min (+ counts).

    With ``use_kernel`` it is one launch of kernels/fused_vocab, which
    **updates ``state.first_pos`` (and ``counts``) in place**; thread the
    returned state through. Without, the unfused chain returns a new
    state. The state is bit-identical either way.
    """
    if use_kernel:
        from repro_torch.kernels.fused_vocab import ops as fv_ops

        return fv_ops.fused_update(state, sparse, valid)
    modded = positive_modulus(sparse, int(state.first_pos.shape[1]))
    return vocab_lib.update(state, modded, valid)


def fused_decode_transform(
    vocab: vocab_lib.Vocabulary,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    n_dense: int,
    n_sparse: int,
    max_rows: int,
    use_kernel: bool = True,
):
    """The whole loop ② — Decode → Modulus → ApplyVocab ∥ Neg2Zero →
    Logarithm — from raw UTF-8 bytes.

    With ``use_kernel`` it is one launch of kernels/fused_decode_xform (the
    plain version for a CPU buffer); without, that plain version: the plain
    decode and the unfused operators. Labels and ids are bit-identical and
    dense values within rtol 1e-6 either way, padding rows included.

    byte_buf uint8 [B] — whole rows + zero padding, any length.
    → (label int32 [max_rows], dense f32 [max_rows, n_dense],
       ids int32 [max_rows, n_sparse], valid bool [max_rows]).
    """
    if use_kernel:
        from repro_torch.kernels.fused_decode_xform import ops as fdx_ops

        return fdx_ops.fused_decode_transform(
            vocab, byte_buf, n_fields=n_fields, hex_start=1 + n_dense, max_rows=max_rows
        )
    from repro_torch.kernels.fused_decode_xform import ref as fdx_ref

    return fdx_ref.fused_decode_transform(
        vocab, byte_buf, n_fields=n_fields, hex_start=1 + n_dense, max_rows=max_rows
    )


def fused_decode_vocab_update(
    state: vocab_lib.VocabState,
    byte_buf: torch.Tensor,
    *,
    n_fields: int,
    n_dense: int,
    n_sparse: int,
    max_rows: int,
    use_kernel: bool = True,
) -> vocab_lib.VocabState:
    """The whole loop ① — Decode → Modulus → GenVocab scatter-min — from raw
    UTF-8 bytes.

    With ``use_kernel`` it is one launch of kernels/fused_decode_vocab,
    which on the card **updates ``state.first_pos`` in place**; thread the
    returned state through. Without, its plain version (the plain decode
    and the unfused chain) returns a new state. The state is bit-identical
    either way. ``n_sparse`` is ``n_fields - 1 - n_dense``; it is taken for
    the reference's signature.
    """
    if use_kernel:
        from repro_torch.kernels.fused_decode_vocab import ops as fdv_ops

        return fdv_ops.fused_decode_update(
            state, byte_buf, n_fields=n_fields, hex_start=1 + n_dense, max_rows=max_rows
        )
    from repro_torch.kernels.fused_decode_vocab import ref as fdv_ref

    return fdv_ref.fused_decode_genvocab(
        state, byte_buf, n_fields=n_fields, hex_start=1 + n_dense, max_rows=max_rows
    )
