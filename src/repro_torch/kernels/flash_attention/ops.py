"""Public wrapper of the flash-attention kernel (csrc/flash_attention.cu).

``flash_attention(q, k, v, causal=...)`` keeps the reference's layout
(q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``), its checks and their
messages. On CUDA tensors it launches the kernel, once per call, on the
route that :func:`route` names for the dtype and head_dim (no route falls
back to another: a refused launch or tensor map raises); on CPU tensors it
takes the plain version (``ref.mha``). Both routes raise
``ValueError`` for a causal call with ``Sq != Skv``: the kernel aligns
causal queries top-left and ``ref.mha`` bottom-right, and the two agree
only when the lengths are equal. The kernel is forward only, like the
reference's: a backward through this function raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

BLOCK = 128  # the reference's default block: Sq and Skv must divide by min(BLOCK, S)
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 on TMA + wgmma; the rest of bf16 on mma.sync
BF16_HEAD_DIMS = (16, 32) + WGMMA_HEAD_DIMS
MAX_F32_HEAD_DIM = 256
# route → (its code in the C entry point, query rows per block)
ROUTES = {"f32": (0, 32), "mma_sync": (1, 64), "wgmma": (2, 128)}

_P, _I, _I64 = _build.PTR, _build.INT, _build.INT64
KERNEL = _build.Kernel("flash_attention", "flash_attention", [_P] * 4 + [_I64] * 9 + [_I] * 8)
LAUNCH_ENTRIES = {"flash_attention": 0}  # C symbol → entry of flash_attention_launch_config
# csrc/flash_attention.cu's launch constants by route: (threads a block,
# dynamic shared bytes by head_dim). The wgmma tiles: Q, the K and V rings
# (80 keys at D 256, else 128; 4 stages a ring at D 64, else 2), their
# mbarriers and 1024 bytes of alignment slack; mma_sync: Q and two stages
# of K and V of 64 keys, rows padded by 8; f32: see f32_smem_bytes.
_WG_STAGES = {64: (128, 4), 128: (128, 2), 256: (80, 2)}  # keys a tile, stages a ring
_THREADS = {"f32": 256, "mma_sync": 128, "wgmma": 384}


def route_smem_bytes(route_name: str, head_dim: int) -> int:
    """Dynamic shared bytes of one block of ``route_name`` at ``head_dim``."""
    if route_name == "wgmma":
        keys, stages = _WG_STAGES[head_dim]
        barriers = 1 + 2 * (2 * stages)
        return 1024 + 128 * head_dim * 2 + 2 * stages * keys * head_dim * 2 + 8 * barriers
    if route_name == "mma_sync":
        return (64 + 4 * 64) * (head_dim + 8) * 2
    rows = keys = 32
    floats = (rows * (head_dim + 1) + keys * (head_dim + 1) + keys * head_dim + rows * head_dim
              + rows * (keys + 1) + 3 * rows)
    return 4 * floats


def launch_accounting(symbol: str, batch: int, hq: int, len_q: int, head_dim: int,
                      route_code: int) -> list[dict]:
    """The launches of ``symbol`` over ``batch`` x ``hq`` heads of ``len_q``
    queries on route ``route_code`` (``ROUTES``), as
    ``flash_attention_launch_config`` reports them: a block per head and per
    tile of query rows, opting in to all of its dynamic shared memory."""
    if symbol not in LAUNCH_ENTRIES:
        raise ValueError(f"flash_attention has no entry point {symbol!r}")
    name = next(n for n, (code, _) in ROUTES.items() if code == route_code)
    rows = ROUTES[name][1]
    kernel = {"f32": "flash_f32_kernel", "mma_sync": "flash_bf16_kernel",
              "wgmma": "flash_wgmma_kernel"}[name]
    smem = route_smem_bytes(name, head_dim)
    return [_build.launch_record(kernel, (batch * hq, -(-len_q // rows)), _THREADS[name], smem,
                                 smem)]


def takes(len_q: int, len_kv: int, *, causal: bool) -> bool:
    """Whether :func:`flash_attention` takes ``len_q`` queries over ``len_kv``
    keys: each length a positive multiple of ``min(BLOCK, length)``, and equal
    when ``causal`` (the sequence half of :func:`_check_shapes`). The LM
    chooses its route with it; a layer the kernel does not take runs the
    chunked route."""
    if len_q <= 0 or len_kv <= 0 or (causal and len_q != len_kv):
        return False
    return len_q % min(BLOCK, len_q) == 0 and len_kv % min(BLOCK, len_kv) == 0


def _check_shapes(q, k, v, *, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head_dim")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    bq = min(BLOCK, sq)
    bk = min(BLOCK, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide blocks ({bq},{bk})")
    if causal and sq != skv:
        raise ValueError(
            f"causal attention with Sq={sq} != Skv={skv}: the kernel aligns causal queries "
            "top-left and ref.mha bottom-right; they agree only for Sq == Skv")


def _check_strides(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} like q, got {t.dtype}")
    per_16_bytes = 16 // t.element_size()
    if t.stride(3) != 1 or any(t.stride(i) % per_16_bytes for i in range(3)) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: the kernel reads rows through (batch, head, row) strides; it needs a "
            f"contiguous last dimension and 16-byte aligned rows, got strides {t.stride()}")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel route of a CUDA call, by shape alone: ``"wgmma"`` (bf16 at
    head_dim 64, 128, 256: TMA-fed stages, wgmma, a producer warpgroup),
    ``"mma_sync"`` (bf16 at 16, 32) or ``"f32"`` (float32 on the CUDA
    cores). Raises for what no route takes."""
    if dtype == torch.bfloat16:
        if head_dim not in BF16_HEAD_DIMS:
            raise ValueError(f"head_dim {head_dim}: the bf16 kernel takes {BF16_HEAD_DIMS}")
        return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"
    if dtype == torch.float32:
        if head_dim % 4 or head_dim > MAX_F32_HEAD_DIM:
            raise ValueError(f"head_dim {head_dim}: the float32 kernel takes multiples of 4 up "
                             f"to {MAX_F32_HEAD_DIM}")
        return "f32"
    raise TypeError(f"q: expected bfloat16 or float32, got {dtype}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    code, rows_per_block = ROUTES[route(q.dtype, d)]
    if b * hq >= 2**31 or -(-sq // rows_per_block) >= 2**16 or skv >= 2**31:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: too large for one launch")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_strides(t, name, q.dtype, q.device)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("k: no keys to attend to")
    p = _build.ptr
    KERNEL.launch(
        q.device, p(q), p(k), p(v), p(out), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, hq, hkv, sq, skv, d, int(causal), code)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            return ref.mha(q, k, v, causal=causal)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        raise RuntimeError(
            "flash_attention has no gradient: the kernel is forward only, as the reference's "
            "is; train through attention_chunked (LM attn_impl='chunked')")


@_build.entry(KERNEL)
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k/v [B, Hkv, Skv, D]; Hq % Hkv == 0 → [B, Hq, Sq, D]
    in q's dtype.

    Sq and Skv must divide by ``min(128, Sq)`` and ``min(128, Skv)``, the
    reference's contract at its default blocks; the CUDA kernel picks its
    own tiles. Causal calls need ``Sq == Skv``.
    """
    _check_shapes(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal)
