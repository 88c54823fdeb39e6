"""Plain PyTorch version of blockwise (flash) attention.

Counterpart of ``repro/kernels/flash_attention/ref.py::mha``, line for
line: the kv heads are repeated, everything is computed in float32, and
causal queries are aligned bottom-right (query ``i`` sees keys up to
``i + Skv - Sq``). The kernel aligns them top-left; the two agree only when
``Sq == Skv``, so the public wrapper (``ops.flash_attention``) takes causal
calls with ``Sq == Skv`` only.
"""

from __future__ import annotations

import math

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Multi-head attention with optional causal mask; GQA via head groups.

    q [B, Hq, Sq, D]; k/v [B, Hkv, Skv, D] with Hq % Hkv == 0. Computed in
    float32 whatever the input type; returns q's dtype.
    """
    _, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qf = q.to(torch.float32)
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    vf = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / torch.tensor(
        math.sqrt(d), dtype=torch.float32
    )
    if causal:
        skv = k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # right-aligned queries
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)
