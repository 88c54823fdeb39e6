"""Public wrapper of the dense-transform kernel (csrc/dense_xform.cu).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor always
launches the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dense_xform import ref

KERNEL = _build.Kernel(
    "dense_xform", "dense_transform", [_build.PTR, _build.PTR, _build.INT64, _build.INT]
)
LAUNCH_ENTRIES = {"dense_transform": 0}  # C symbol → entry of dense_xform_launch_config
THREADS = 128  # csrc/dense_xform.cu kThreads


def launch_accounting(symbol: str, n: int, is_f32: int, *, wave: int | None = None
                      ) -> list[dict]:
    """The launches of ``symbol`` over ``n`` elements, as
    ``dense_xform_launch_config`` reports them: a block of 128 threads per
    128 quads of an aligned output, at most ``wave`` blocks (the card's
    resident wave of the kernel for that input type; None: uncapped)."""
    if symbol not in LAUNCH_ENTRIES:
        raise ValueError(f"dense_xform has no entry point {symbol!r}")
    want = max(1, -(-(n // 4) // THREADS))
    return [_build.launch_record("dense_xform_kernel", (want if wave is None else min(want, wave),),
                                 THREADS, cap=wave or 0)]


@_build.entry(KERNEL)
def dense_transform(dense: torch.Tensor) -> torch.Tensor:
    """Neg2Zero + Logarithm in one launch: dense int32 or f32, any shape
    → f32 ``log1p(max(x, 0))`` of the same shape."""
    if dense.device.type == "cpu":
        return ref.dense_transform(dense)
    if dense.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"dense: expected int32 or float32, got {dense.dtype}")
    _build.check(dense, "dense", dense.dtype)
    out = torch.empty(dense.shape, dtype=torch.float32, device=dense.device)
    if dense.numel():
        p = _build.ptr
        KERNEL.launch(
            dense.device, p(dense), p(out), dense.numel(), int(dense.dtype == torch.float32)
        )
    return out
