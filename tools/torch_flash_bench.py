#!/usr/bin/env python3
"""The port's flash-attention kernel alone on one NVIDIA GPU: build, check, time.

    python3 tools/torch_flash_bench.py [--src SRC] [--out results.json] [--label NAME]
    python3 tools/torch_flash_bench.py --rehearse     # plumbing only, on the CPU

``--src`` is a ``src/`` directory that holds a ``repro_torch`` package
(default: this checkout's); run the script once per tree, in one command,
to compare two trees on one card (old, new, new, old). It prints, one JSON
object a line:

1. ``build``: the seconds to build ``csrc/flash_attention.cu`` and, for
   each kernel instantiation, the registers and spill bytes ``ptxas -v``
   reported;
2. ``check``: the kernel against ``ref.mha`` on seeded random inputs,
   smallest first, each one synchronised: the largest error and the
   largest relative L2 error over (batch, head, 256 query rows), held to
   the reference's 2e-2 (bf16) / 2e-5 (float32) and to 1e-2 / 1e-4;
3. ``time``: at gemma-2b's prefill shapes (bf16 q [B, 8, S, 256], k/v
   [B, 1, S, 256], causal; B 4 x S 4096 and B 1 x S 32768) the kernel and
   scaled_dot_product_attention (the default dispatch, and each backend
   forced in turn), timed alike: CUDA events around back-to-back calls
   after a warm-up, in the order kernel, SDPA, SDPA, kernel, the two runs
   of each pooled. TFLOP/s count the causal half of 4·B·H·S²·D.

The last line holds every record, with the card's name and power limit
(nvidia-smi). It exits non-zero if a check failed or there is no card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TENSOR_CORE_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12
# (B, Hq, Hkv, S, D, dtype, causal), smallest first
CHECKS = [
    (1, 2, 2, 48, 256, "bfloat16", True), (1, 8, 1, 64, 256, "bfloat16", True),
    (1, 4, 4, 128, 64, "bfloat16", True), (1, 8, 1, 256, 128, "bfloat16", True),
    (1, 8, 1, 96, 256, "bfloat16", False), (2, 8, 1, 384, 256, "bfloat16", True),
    (1, 4, 4, 512, 128, "bfloat16", False), (2, 8, 2, 256, 64, "bfloat16", True),
    (1, 8, 1, 1024, 256, "bfloat16", True), (2, 4, 1, 64, 16, "bfloat16", True),
    (2, 2, 2, 512, 32, "bfloat16", True), (1, 8, 1, 256, 256, "float32", True),
    (4, 8, 1, 4096, 256, "bfloat16", True),
]
REHEARSAL_CHECKS = [c for c in CHECKS if c[3] <= 256]
SHAPES = {"B4xS4096": (4, 4096), "B1xS32768": (1, 32768)}
REHEARSAL_SHAPES = {"B4xS4096": (1, 128)}
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-4)}
SEGMENT_ROWS = 256
# each kernel instantiation of csrc/flash_attention.cu, by its mangled name
ENTRIES = {"wgmma<256>": "flash_wgmma_kernelILi256E", "wgmma<128>": "flash_wgmma_kernelILi128E",
           "wgmma<64>": "flash_wgmma_kernelILi64E", "mma_sync<32>": "flash_bf16_kernelILi32E",
           "mma_sync<16>": "flash_bf16_kernelILi16E", "f32": "flash_f32_kernel"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def segment_rel_l2(torch, got, want) -> float:
    b, h, s, d = want.shape
    rows = math.gcd(SEGMENT_ROWS, s)
    shape = (b, h, s // rows, rows * d)
    diff = (got.float() - want.float()).reshape(shape).norm(dim=-1)
    return float((diff / want.float().reshape(shape).norm(dim=-1).clamp_min(1e-30)).max())


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import ptxas_usage
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cpu" if args.rehearse else "cuda")
    records = {"label": args.label, "src": args.src}
    if not args.rehearse:
        records["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        t0 = time.perf_counter()
        path = _build.build(("flash_attention",))["flash_attention"]
        log = Path(f"{path}.log").read_text()
        records["build"] = {"seconds": time.perf_counter() - t0,
                            "ptxas": {k: ptxas_usage(log, e) for k, e in ENTRIES.items()}}
        emit({"build": records["build"]})

    failed = []
    records["checks"] = []
    for b, hq, hkv, s, d, dt, causal in (REHEARSAL_CHECKS if args.rehearse else CHECKS):
        dtype = getattr(torch, dt)
        gen = torch.Generator(dev).manual_seed(s * 1000 + d)
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
        ops.KERNEL.launches = 0
        got = ops.flash_attention(q, k, v, causal=causal)
        if not args.rehearse:
            torch.cuda.synchronize()
        want = ref.mha(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        rel = segment_rel_l2(torch, got, want)
        tol, rel_tol = TOL[dt]
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)) and rel <= rel_tol
        rec = {"shape": [b, hq, hkv, s, d], "dtype": dt, "causal": causal,
               "route": ops.route(dtype, d), "launches": ops.KERNEL.launches,
               "max_abs_err": err, "segment_rel_l2": rel, "ok": ok}
        emit({"check": rec})
        records["checks"].append(rec)
        if not ok:
            failed.append(rec["shape"])
        del q, k, v, got, want

    records["times"] = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for tag, (b, s) in (REHEARSAL_SHAPES if args.rehearse else SHAPES).items():
        hq, hkv, d = 8, 1, 256
        gen = torch.Generator(dev).manual_seed(12)
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        ops_n = 4 * b * hq * s * s * d // 2
        io = (2 * b * hq + 2 * b * hkv) * s * d * 2
        bound_ms = max(ops_n / TENSOR_CORE_BF16_OPS_PER_S, io / HBM_BYTES_PER_S) * 1e3
        rec = {"shape": f"q [{b}, {hq}, {s}, {d}], k/v [{b}, {hkv}, {s}, {d}] bf16 causal",
               "route": ops.route(torch.bfloat16, d), "bound_ms": bound_ms}

        def kernel():
            return ops.flash_attention(q, k, v)

        def library():
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)

        if args.rehearse:
            kernel(), library()
            emit({"time": {tag: rec}})
            continue
        reps = 20 if s <= 4096 else 5
        kt, lt = [], []
        for fn, acc in ((kernel, kt), (library, lt), (library, lt), (kernel, kt)):
            acc.append(time_ms(torch, fn, reps))
        rec.update(ms=sum(kt) / 2, ms_runs=kt, sdpa_ms=sum(lt) / 2, sdpa_ms_runs=lt)
        rec["tflops"] = ops_n / rec["ms"] / 1e9
        rec["sdpa_tflops"] = ops_n / rec["sdpa_ms"] / 1e9
        rec["vs_sdpa"] = rec["ms"] / rec["sdpa_ms"]
        rec["bound_share"] = bound_ms / rec["ms"]
        backends = {}
        for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION"):
            try:
                with sdpa_kernel([getattr(SDPBackend, name)]):
                    backends[name] = time_ms(torch, library, reps)
            except RuntimeError as e:
                backends[name] = f"refused: {str(e).splitlines()[0][:120]}"
        rec["sdpa_backends_ms"] = backends
        emit({"time": {tag: rec}})
        records["times"][tag] = rec
        del q, k, v

    records["failed"] = failed
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))
    emit(records)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
