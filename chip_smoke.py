#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,golden,main,train,serve] [--out results.json]
    python3 chip_smoke.py --rehearse      # plumbing only, on the CPU

Phases, each of which passes or ends the run with a non-zero exit:
  1. device — the card's name, count, torch and CUDA versions, then the
     build of every kernel source in src/repro_torch/kernels/csrc (one
     nvcc per source, all at once), timed, with the registers and spills
     ptxas reported for the bf16 wgmma flash-attention kernel at head_dim
     256 (gemma-2b's), which must not spill.
  2. kernels — each kernel wrapper on tensors on the card, at the main
     path's shapes, against its plain PyTorch version on the same inputs:
     integers bit for bit, dense f32 at rtol 1e-6. Times each kernel, its
     plain version and, where one PyTorch call does comparable work, that
     call (CUDA events, warmed up), beside the least time the card could
     take (bytes over 3.35 TB/s, or operations over 67 T/s). fused_genvocab
     is also timed on fresh states (every slot NEVER) and on the binary
     feed's first chunk (every row live, its own bound), beside an empty
     kernel's device time (the launch floor); the embedding gradient's
     record shows its zeroing, sort and sum apart (one torch.profiler pass).
  3. golden — PiperPipeline on the card over tests/goldens/fused_small.npz,
     and with use_fused_decode=True over decode_fused_small.npz, reproduces
     the stored labels, ids and dense values and their digest.
  4. main — the pipeline at CRITEO (5K) and CRITEO_1M: a utf8 feed (on the
     decoded route, then on the bytes-in route of use_fused_decode=True) and
     a binary BinaryChunkFeed, each through run_stream, run_scan and a few
     requests served by FrozenVocabTransform, and once with
     track_vocab_counts and finalize_topk, each held to the same pipeline
     with the fused hints False (the unfused chain) over the whole output,
     padding rows included. Every launch counter is set to 0 before each of
     these runs and read after; a kernel of the path that never launched
     fails the run, and so does a bytes-in chunk that launched anything but
     one bytes-in kernel per loop.
  5. train — Piper → DLRM training at CONFIG_5K and CONFIG_1M (full width,
     batches of 4096 rows, AdamW with global-norm clipping, TF32 off):
     run_stream over the utf8 feed with the default hints, its valid rows
     through TrainInputPipeline, then 50 (5K) or 20 (1M) train steps with
     the loss read one step lagged. Every step must launch exactly one
     embedding_gather and one embedding_gather_backward; the loss must be
     finite and fall (last 10 steps against the first 10); one checkpoint
     with Piper's VocabState under extra must restore bit for bit. At 5K
     the first 5 steps are held to the port's CPU path on the same weights
     and batches (loss, grad_norm, step-1 gradients), and a second run from
     the same seed must end in bit-identical weights and optimizer state.
     Prints ms per step, rows/s, the device's busy share of one profiled
     step and the peak device memory.
  6. serve — gemma-2b at its published width and depth (18 layers, random
     weights from a seeded generator on the card, f32 at rest, bf16
     compute, TF32 off). The flash-attention kernel against its plain
     version at the layer's shapes (bf16 at 2e-2, f32 at 2e-5, an MHA head
     map, a non-causal call), timed beside scaled_dot_product_attention
     alike (CUDA events, kernel, SDPA, SDPA, kernel), with its route,
     TFLOP/s, share of the bound, and the SDPA backend the default call
     ran (each backend is also timed, forced in turn).
     A prefill of 4 x 4096 tokens (PiperTokenBatches over the sparse ids of
     the 5K utf8 run) must launch the kernel exactly once per layer and
     agree with the same prefill through attn_impl="chunked"; a prefill of
     1 x 32768 tokens runs through the kernel alone, timed; ServeEngine
     (4 slots, cache 1024) serves 8 requests of 64 prompt tokens and 16 new
     ones, and one request's logits at its last prompt position must agree
     with the prefill step on that prompt. Prints prefill tokens/s, decode
     ms per engine step, tokens/s and the peak device memory.

The last lines are the {"kernels": [...]} summary, the nvidia-smi name
and power limit, and {"ok": true, "device": {...}}. Without a CUDA device,
or without the repository's src/ beside this file, it exits non-zero and
prints no result. --rehearse runs the same phases on the CPU at a tiny
size, where every wrapper takes its plain version: it checks the script,
times nothing and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
TENSOR_CORE_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
TPU_KERNELS = {  # kernel → (replaced Pallas kernel, the port's source)
    "decode_scan": ("src/repro/kernels/decode_utf8/kernel.py:195", "decode_utf8.cu"),
    "fused_genvocab": ("src/repro/kernels/fused_vocab/kernel.py:113", "fused_vocab.cu"),
    "fused_genvocab_slabs": ("src/repro/kernels/fused_vocab/kernel.py:215", "fused_vocab.cu"),
    "fused_transform": ("src/repro/kernels/fused_xform/kernel.py:80", "fused_xform.cu"),
    "fused_mod_dense": ("src/repro/kernels/fused_xform/kernel.py:136", "fused_xform.cu"),
    "fused_decode_genvocab": ("src/repro/kernels/fused_decode_vocab/kernel.py:122",
                              "fused_decode_vocab.cu"),
    "fused_decode_transform": ("src/repro/kernels/fused_decode_xform/kernel.py:124",
                               "fused_decode_xform.cu"),
    "genvocab": ("src/repro/kernels/vocab/kernel.py:83", "vocab.cu"),
    "apply_vocab": ("src/repro/kernels/vocab/kernel.py:40", "vocab.cu"),
    "dense_transform": ("src/repro/kernels/dense_xform/kernel.py:25", "dense_xform.cu"),
    "embedding_gather": ("src/repro/kernels/embedding_bag/kernel.py:25", "embedding_bag.cu"),
    "embedding_gather_backward": (
        "none: the JAX package's gradient is XLA's scatter-add through "
        "src/repro/kernels/embedding_bag/ref.py:10", "embedding_bag.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention/kernel.py:87", "flash_attention.cu"),
}
# The kernels the port's main paths run (the decoded route, the bytes-in
# route of use_fused_decode=True, and the crossed plan's use_kernels route);
# fused_mod_dense is a measured alternative route for loop ② at 1M and does
# not run on them.
PATH_KERNELS = ("decode_scan", "fused_genvocab", "fused_genvocab_slabs", "fused_transform",
                "fused_decode_genvocab", "fused_decode_transform", "genvocab", "apply_vocab",
                "dense_transform")
# The kernels the train phase's path runs: Piper's decoded utf8 route with
# the default hints, then the DLRM's embedding gather and its gradient.
TRAIN_KERNELS = ("decode_scan", "fused_genvocab", "fused_transform", "embedding_gather",
                 "embedding_gather_backward")
# The serve phase's path: the prefill's attention layers.
SERVE_KERNELS = ("flash_attention",)
RANGES = {"5K": 5000, "1M": 1_000_000}
# The train phase: batch rows and steps per range; a CPU rehearsal trains
# smaller batches and stands a 20000-row table in for the 1M one.
TRAIN_BATCH, TRAIN_STEPS = 4096, {"5K": 50, "1M": 20}
REHEARSAL_TRAIN_BATCH, REHEARSAL_TRAIN_STEPS = 256, {"5K": 20, "1M": 20}
REHEARSAL_RANGES = {"5K": 5000, "1M": 20000}
CHUNK_BYTES = 1 << 20
MAX_ROWS = 1 << 14
# Rows of the main path's feeds: on the card, and in a CPU rehearsal.
ROWS = {"utf8": 1 << 18, "binary": 1 << 22}
REHEARSAL_ROWS = {"utf8": 8000, "binary": 40000}
# The serve phase: prefill (batch, seq) shapes by tag, and the engine's
# traffic. On the card gemma-2b's CONFIG, in a rehearsal its SMOKE config
# at shorter sequences.
PREFILLS = {"B4xS4096": (4, 4096), "B1xS32768": (1, 32768)}
REHEARSAL_PREFILLS = {"B4xS4096": (4, 256), "B1xS32768": (1, 1024)}
ENGINE = {"slots": 4, "cache_len": 1024, "requests": 8, "prompt_len": 64, "new_tokens": 16}
# Last-position logits of two bf16 routes, held as |Δ|₂ ≤ 5e-2·|ref|₂: each
# layer rounds its attention output or residual sum to bf16 (a relative
# step of 2^-9) at other points on the two routes, which over 18 layers
# adds up as a random walk to about sqrt(18..36)·2^-9 ≈ 1e-2.
SERVE_REL_L2 = 5e-2
# The kernel against ref.mha, besides the reference's elementwise 2e-2 /
# 2e-5: each (batch, head, FLASH_SEGMENT_ROWS query rows) holds
# |Δ|₂ ≤ FLASH_REL_L2·|ref|₂. On N(0, 1) inputs a causal row n's output is
# about e^0.5/sqrt(n) per element, so at 32K the elementwise bound is half
# a typical value; a kernel that drops or repeats one 32-key tile is off by
# about sqrt(32/n) of it, 3.1e-2 in the last rows at 32K, 8.8e-2 at 4096.
# A sound bf16 kernel reads about 2^-9 (the rounding of both outputs and
# of P), float32 about 1e-6 (summation order).
FLASH_SEGMENT_ROWS = 256
FLASH_REL_L2 = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


# The D 256 instantiation of the bf16 wgmma kernel (gemma-2b's), by its
# mangled name in ptxas's log; it must build without spills.
FLASH_WGMMA_D256 = "flash_wgmma_kernelILi256E"


class SmokeFailure(Exception):
    pass


def ptxas_usage(log: str, entry: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for the
    first kernel whose mangled name holds ``entry``; {} if none does."""
    found, usage = False, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if found:
                break
            found = entry in line
        elif found and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif found and "Used" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage["registers"] = int(m.group(1))
    return usage


def counters() -> dict:
    """Kernel name → the launch counter of its wrapper."""
    from repro_torch.kernels.decode_utf8 import ops as dops
    from repro_torch.kernels.dense_xform import ops as dxops
    from repro_torch.kernels.embedding_bag import ops as ebops
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.fused_decode_vocab import ops as fdvops
    from repro_torch.kernels.fused_decode_xform import ops as fdxops
    from repro_torch.kernels.fused_vocab import ops as fvops
    from repro_torch.kernels.fused_xform import ops as fxops
    from repro_torch.kernels.vocab import ops as vops

    return {"decode_scan": dops.KERNEL, "fused_genvocab": fvops.KERNEL,
            "fused_genvocab_slabs": fvops.KERNEL_COUNTS,
            "fused_transform": fxops.KERNEL, "fused_mod_dense": fxops.KERNEL_MOD_DENSE,
            "fused_decode_genvocab": fdvops.KERNEL, "fused_decode_transform": fdxops.KERNEL,
            "genvocab": vops.KERNEL_GENVOCAB, "apply_vocab": vops.KERNEL_APPLY,
            "dense_transform": dxops.KERNEL, "embedding_gather": ebops.KERNEL,
            "embedding_gather_backward": ebops.KERNEL_BACKWARD,
            "flash_attention": faops.KERNEL}


def reset_counters(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


RECORDS = []  # every line emit() printed, for --out


def emit(obj) -> None:
    RECORDS.append(obj)
    print(json.dumps(obj), flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(n_bytes: int, n_ops: int, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_HEX = "0123456789abcdef"
HOSTILE_KINDS = ("normal", "empty_fields", "all_delim", "invalid_hex", "overlong_hex",
                 "overlong_decimal", "weird_minus", "long_straddle")


def hostile_rows(np, seed: int, n_dense: int, n_sparse: int, n_rows: int,
                 truncate: int) -> bytes:
    """Rows of every hostile class: empty fields and all-delimiter rows,
    invalid and overlong hex, overlong decimals, stray minus signs, and
    4136-byte fields, longer than the bytes-in kernels' 4 KiB tiles (and
    than the decode kernel's 256-byte halo). ``truncate`` cuts
    that many bytes (the newline first) off the final row."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        kind = rng.choice(HOSTILE_KINDS)
        label = [str(rng.integers(0, 2))]
        dense = [str(rng.integers(-99, 1000)) for _ in range(n_dense)]
        sparse = ["".join(rng.choice(list(_HEX), size=rng.integers(1, 9)))
                  for _ in range(n_sparse)]
        if kind == "empty_fields":
            for fields in (dense, sparse):
                for i in range(len(fields)):
                    if rng.random() < 0.5:
                        fields[i] = ""
        elif kind == "all_delim":
            label, dense, sparse = [""], [""] * n_dense, [""] * n_sparse
        elif kind == "invalid_hex":
            sparse[rng.integers(0, n_sparse)] = "".join(
                rng.choice(list("ghijklmnopqrstuvwxyzGHIJKLZ!@"), size=4))
        elif kind == "overlong_hex":
            sparse[rng.integers(0, n_sparse)] = "".join(
                rng.choice(list(_HEX), size=rng.integers(9, 17)))
        elif kind == "overlong_decimal":
            dense[rng.integers(0, n_dense)] = str(rng.integers(10**10, 10**14))
        elif kind == "weird_minus":
            dense[rng.integers(0, n_dense)] = str(rng.choice(["--7", "1-2", "-", "3-"]))
        elif kind == "long_straddle":
            sparse[rng.integers(0, n_sparse)] = "".join(rng.choice(list(_HEX), size=4096 + 40))
        rows.append("\t".join(label + dense + sparse).encode())
    raw = b"".join(r + b"\n" for r in rows)
    return raw[: len(raw) - min(truncate, len(rows[-1]) + 1)] if truncate else raw


CRITEO_FIELDS, CRITEO_DENSE = 40, 13  # a label, 13 decimal and 26 hex fields a row


def _row(np, rng, fields: int = CRITEO_FIELDS, field_len: int = 0) -> bytes:
    """One row of ``fields`` fields: a label, decimal dense and hex sparse
    values, or, with ``field_len``, a hex field that long in the last column."""
    vals = [str(rng.integers(0, 2))]
    vals += [str(rng.integers(-99, 10**6)) for _ in range(min(fields - 1, CRITEO_DENSE))]
    vals += ["%x" % rng.integers(0, 2**32) for _ in range(fields - len(vals))]
    if field_len:
        vals[-1] = "".join(rng.choice(list(_HEX), size=field_len))
    return ("\t".join(vals) + "\n").encode()


def _exact_rows(np, rng, length: int) -> bytes:
    """Whole rows of exactly ``length`` bytes (``length`` >= 400): random
    rows, then one of empty fields whose last field fills the rest."""
    out = b""
    while len(out) + 300 + CRITEO_FIELDS <= length:
        out += _row(np, rng)
    last = length - len(out) - CRITEO_FIELDS
    return out + b"\t" * (CRITEO_FIELDS - 1) + b"a" * last + b"\n"


def decode_edge_chunks(np) -> list:
    """(name, uint8 array, max_rows) of the decode kernel's edge cases,
    Criteo rows, for tiles of 4, 8 or 16 KiB: empty and one-byte chunks, a
    length no multiple of 16, a field longer than two 16 KiB tiles, rows a
    field too long or short, a truncated final row, more delimiters than
    cells, an all-padding chunk, and data that ends on a tile boundary and
    one byte past it."""
    rng = np.random.default_rng(7)
    whole = b"".join(_row(np, rng) for _ in range(200))
    long_field = b"".join(_row(np, rng, field_len=2 * 16384 + 700 if i == 3 else 0)
                          for i in range(12))
    widths = b"".join(_row(np, rng, CRITEO_FIELDS + (i % 3 == 1) - (i % 3 == 2))
                      for i in range(60))
    out = [("empty", b"", 64), ("one_byte", b"\n", 64), ("n_4097", whole[:4097], 64),
           ("long_field_over_two_tiles", long_field, 64),
           ("field_widths_off_by_one", widths, 64), ("truncated_row", whole[:-9], 256),
           ("more_delims_than_cells", whole, 37), ("all_padding", bytes(3 * 16384 + 5), 64)]
    for length in (8192, 16384):
        ends = _exact_rows(np, rng, length)
        out += [(f"ends_on_{length}", ends, 256), (f"ends_one_byte_past_{length}", ends + b"7", 256)]
    return [(name, np.frombuffer(raw, np.uint8).copy(), mr) for name, raw, mr in out]


class Smoke:
    """The phases, on the card, or on the CPU for a rehearsal."""

    def __init__(self, torch, np, rehearse: bool):
        self.torch, self.np = torch, np
        self.rehearse = rehearse
        self.dev = torch.device("cpu" if rehearse else "cuda")

    # -- measurement ---------------------------------------------------- #
    def sync(self) -> None:
        if not self.rehearse:
            self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int = 20, warmup: int = 3) -> dict:
        """Two times of one call of ``fn``, averaged over ``reps`` calls:

        ``device_ms`` — the device time of the kernels the call launches,
        summed from torch.profiler traces (the kernel's own time). A trace
        now and then comes back with no device events, or with some
        launches missing, so it is used only when two traces in a row hold
        the same count of each device kernel, each a multiple of ``reps``,
        and at least one device kernel for each launch the wrappers counted
        during the trace; else None;
        ``call_ms`` — CUDA-event time per call, calls back to back, which
        also holds whatever host time the wrapper takes between launches.
        Both None in a rehearsal."""
        if self.rehearse:
            fn()
            return {"device_ms": None, "call_ms": None}
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        call_ms = self.event_ms(fn, reps, warmup)
        kernels = counters()
        device_ms, previous, passes = None, None, []
        for _ in range(4):
            reset_counters(kernels)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            launched = sum(k.launches for k in kernels.values())
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            counts = {e.key: e.count for e in events}
            passes.append({"launched": launched, "counts": {k[:48]: c for k, c in counts.items()}})
            whole = (events and all(c % reps == 0 for c in counts.values())
                     and sum(counts.values()) >= launched)
            this = (counts, sum(e.self_device_time_total for e in events)) if whole else None
            if this and previous and this[0] == previous[0]:
                device_ms = (this[1] + previous[1]) / 2 / 1e3 / reps
                break
            previous = this
        if device_ms is None:  # what the rejected traces held, for the record
            return {"device_ms": None, "call_ms": call_ms, "rejected_traces": passes}
        return {"device_ms": device_ms, "call_ms": call_ms}

    def event_ms(self, fn, reps: int = 20, warmup: int = 3) -> float | None:
        """CUDA-event time per call of ``fn``, ``reps`` calls back to back
        after ``warmup`` more; None in a rehearsal (one call)."""
        if self.rehearse:
            fn()
            return None
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def times(self, kernel, plain, library=None, plain_reps: int = 20) -> dict:
        """The kernel's, its plain version's and the library call's times:
        ``*_ms`` is the device time (the event time where the trace shows
        none, as ``ms_from`` says), ``*_call_ms`` the event time per call."""
        k = self.time_ms(kernel)
        p = self.time_ms(plain, reps=plain_reps)
        lib = self.time_ms(library) if library else {"device_ms": None, "call_ms": None}

        def pick(t):
            return t["device_ms"] if t["device_ms"] is not None else t["call_ms"]

        def source(t):
            return "profiler" if t["device_ms"] is not None else "cuda_events"

        rejected = {key: t["rejected_traces"] for key, t in (("ms", k), ("plain_ms", p),
                                                               ("library_ms", lib))
                    if t.get("rejected_traces")}
        return {"ms": pick(k), "plain_ms": pick(p), "library_ms": pick(lib),
                "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                "library_call_ms": lib["call_ms"],
                "ms_from": {"ms": source(k), "plain_ms": source(p), "library_ms": source(lib)},
                **({"rejected_traces": rejected} if rejected else {})}

    def each_ms(self, calls) -> float | None:
        """Device ms per call of one torch.profiler pass over ``calls``, each
        a different call (so each may start from its own prepared state),
        summed over every kernel and memset the pass ran; None in a
        rehearsal, or when the trace holds fewer kernels than the wrappers
        counted launches."""
        if self.rehearse:
            for c in calls:
                c()
            return None
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        kernels = counters()
        reset_counters(kernels)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c in calls:
                c()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in events) < sum(k.launches for k in kernels.values()):
            return None
        return sum(e.self_device_time_total for e in events) / 1e3 / len(calls)

    def stages(self, fn, reps: int = 5) -> dict | None:
        """Device ms per call of each kernel and memset that ``fn`` runs, by
        name, from one short torch.profiler pass over ``reps`` calls (short,
        so the trace keeps every launch); None in a rehearsal."""
        if self.rehearse:
            fn()
            return None
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: {"count": e.count, "ms": e.self_device_time_total / 1e3 / reps}
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total}

    def launch_floor(self) -> float | None:
        """Device ms of one empty kernel (csrc/fused_vocab.cu), launched
        back to back on the current stream: the floor under the µs
        kernels. None in a rehearsal."""
        if self.rehearse:
            return None
        import ctypes

        from repro_torch.kernels import _build

        fn = _build.library("fused_vocab").empty_kernel
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        torch = self.torch

        def launch():
            expect(fn(torch.cuda.current_stream().cuda_stream) == 0, "empty_kernel: refused")

        return self.each_ms([launch] * 50)

    def fresh_ms(self, vocab_lib, n_cols, vr, track, rows_seen, sparse, valid, update,
                 reps: int = 10) -> float | None:
        """Device ms of ``update`` on a fresh state (every slot NEVER, counts
        0, at ``rows_seen``), a new one for each of ``reps`` calls, all made
        before the profiled pass."""
        states = [vocab_lib.VocabState.init(n_cols, vr, track_counts=track, device=self.dev)
                  for _ in range(1 if self.rehearse else reps)]
        for st in states:
            st.rows_seen.copy_(rows_seen)
        return self.each_ms([lambda st=st: update(st, sparse, valid) for st in states])

    def binary_genvocab(self, data, vocab_lib, fvops, fvref, base, vr) -> dict:
        """fused_genvocab on the binary feed's first chunk (every row live),
        bit for bit against its plain version on the filled and on a fresh
        state, and its times (filled and fresh) with its own bound."""
        torch, dev = self.torch, self.dev
        sparse = torch.from_numpy(data["binary"]["sparse"][:MAX_ROWS]).to(dev)
        rows, n_cols = sparse.shape
        valid = torch.ones(rows, dtype=torch.bool, device=dev)
        fresh = vocab_lib.VocabState.init(n_cols, vr, device=dev)
        fresh.rows_seen.copy_(base.rows_seen)
        for what, start in (("filled", base), ("fresh", fresh)):
            def state():
                return vocab_lib.VocabState(start.first_pos.clone(), start.rows_seen.clone())

            got = fvops.fused_update(state(), sparse, valid)
            want = state()
            want_seen = fvref.fused_genvocab(want.first_pos, None, sparse, valid, want.rows_seen)
            self.sync()
            where = f"fused_genvocab V={vr}, binary chunk, {what} state"
            expect(torch.equal(got.first_pos, want.first_pos), f"{where}: first_pos differs")
            expect(torch.equal(got.rows_seen, want_seen), f"{where}: rows_seen differs")
        from repro_torch.core.uint32 import as_u32

        slots = torch.arange(n_cols, device=dev)[None, :] * vr + as_u32(sparse) % vr
        touched = int(torch.unique(slots).numel())
        b_ms, b_by = bound(rows * n_cols * 4 + rows + 8 + touched * 8, 4 * rows * n_cols)
        st = vocab_lib.VocabState(base.first_pos.clone(), base.rows_seen.clone())
        return {"ms": self.time_ms(lambda: fvops.fused_update(st, sparse, valid))["device_ms"],
                "fresh_ms": self.fresh_ms(vocab_lib, n_cols, vr, False, base.rows_seen, sparse,
                                          valid, fvops.fused_update),
                "bound_ms": b_ms, "bound_by": b_by, "shape": f"[{rows}, {n_cols}], all live"}

    def wall_seconds(self, fn, n: int = 5) -> list[float]:
        """Host-clock seconds of each of ``n`` runs of ``fn`` (one in a
        rehearsal), each ending in a synchronize."""
        times = []
        for _ in range(1 if self.rehearse else n):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append(time.perf_counter() - t0)
        return times

    def profile(self, fn) -> list | None:
        """The device's kernels and copies during one call of ``fn``
        (torch.profiler), by name: ``{"name", "count", "ms"}``, most device
        time first. None in a rehearsal."""
        if self.rehearse:
            fn()
            return None
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total]
        return sorted(rows, key=lambda r: -r["ms"])

    def device_seconds(self, fn) -> float | None:
        """Seconds the device spent in kernels and copies during one call of
        ``fn`` (torch.profiler); None in a rehearsal."""
        rows = self.profile(fn)
        return None if rows is None else sum(r["ms"] for r in rows) / 1e3

    # -- phase 1 -------------------------------------------------------- #
    def device(self) -> dict:
        torch = self.torch
        if self.rehearse:
            info = {"name": "cpu (rehearsal)", "count": 0, "torch": torch.__version__,
                    "nvidia_smi": "cpu rehearsal: no card"}
            emit({"phase": "device", **info})
            return info
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "python": sys.version.split()[0], "nvidia_smi": smi}
        emit({"phase": "device", **info})
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        paths = _build.build()
        seconds = time.perf_counter() - t0
        logs = {src: Path(f"{path}.log").read_text() for src, path in paths.items()}
        ptxas = {src: [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "Compiling entry" in ln]
                 for src, log in logs.items()}
        flash = ptxas_usage(logs["flash_attention"], FLASH_WGMMA_D256)
        emit({"phase": "build", "seconds": seconds,
              "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()},
              "ptxas": ptxas, "flash_wgmma_d256": flash})
        expect(flash.get("spill_stores") == 0 and flash.get("spill_loads") == 0,
               f"flash_attention.cu: the D 256 wgmma kernel spills ({flash})")
        info["flash_wgmma_d256"] = flash
        return info

    # -- phase 2 -------------------------------------------------------- #
    def kernels(self, data) -> dict:
        """Every kernel against its plain version at the main path's
        shapes. Returns entry name → record."""
        torch, np, dev = self.torch, self.np, self.dev
        from repro_torch.core import ops, schema as schema_lib, vocab as vocab_lib
        from repro_torch.core.uint32 import as_u32
        from repro_torch.kernels import _build
        from repro_torch.kernels.decode_utf8 import ops as dops, ref as dref
        from repro_torch.kernels.dense_xform import ops as dxops, ref as dxref
        from repro_torch.kernels.fused_decode_vocab import ops as fdvops, ref as fdvref
        from repro_torch.kernels.fused_decode_xform import ops as fdxops, ref as fdxref
        from repro_torch.kernels.fused_vocab import ops as fvops, ref as fvref
        from repro_torch.kernels.fused_xform import ops as fxops, ref as fxref
        from repro_torch.kernels.vocab import ops as vops, ref as vref

        sch = schema_lib.CRITEO
        hex_table = sch.field_is_hex()
        records = {}

        def record(name, rec):
            records[name] = rec
            emit({"phase": "kernels", "kernel": name, **rec})

        # decode: the first 1 MiB chunk of the utf8 feed, then hostile chunks
        def decode_both(buf, max_rows, what):
            kw = dict(n_fields=sch.n_fields, max_rows=max_rows, n_dense=sch.n_dense,
                      n_sparse=sch.n_sparse)
            got = dops.decode(buf, hex_table, **kw)
            want = dref.decode_bytes(buf, hex_table, **kw)
            self.sync()
            for name, g, w in zip(("label", "dense", "sparse", "valid"), got, want):
                expect(torch.equal(g, w), f"decode {what}: {name} differs from the plain version")
            return kw

        buf = torch.from_numpy(data["utf8_chunks"][0]).to(dev)
        kw = decode_both(buf, MAX_ROWS, "synth 1 MiB chunk")
        byte_chunks = [(buf, MAX_ROWS, "synth 1 MiB chunk")]
        cases = [(3000, 2048, 7), (3000, 4096, 0), (400, 512, 1), (64, 32, 40)]
        for seed, (n_rows, max_rows, truncate) in enumerate(cases):
            raw = hostile_rows(np, seed, sch.n_dense, sch.n_sparse, n_rows, truncate)
            hostile = np.zeros(len(raw) + 4096, np.uint8)
            hostile[: len(raw)] = np.frombuffer(raw, np.uint8)
            what = f"hostile chunk {seed} ({n_rows} rows, max_rows {max_rows})"
            byte_chunks.append((torch.from_numpy(hostile).to(dev), max_rows, what))
            decode_both(byte_chunks[-1][0], max_rows, what)
        for name, arr, max_rows in decode_edge_chunks(np):
            decode_both(torch.from_numpy(arr).to(dev), max_rows, f"edge chunk {name}")

        # the launch floor: an empty kernel's device time on the same stream
        floor_ms = self.launch_floor()
        emit({"phase": "kernels", "launch_floor_ms": floor_ms,
              "what": "device time of an empty kernel (fused_vocab.cu::empty_kernel)"})

        n = buf.numel()
        b_ms, b_by = bound(n + MAX_ROWS * (4 * sch.n_fields + 1), 12 * n)
        stages = self.stages(lambda: dops.decode(buf, hex_table, **kw))
        record("decode_scan", {
            "max_abs_err": 0,
            **self.times(lambda: dops.decode(buf, hex_table, **kw),
                         lambda: dref.decode_bytes(buf, hex_table, **kw), plain_reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{n} B chunk, max_rows {MAX_ROWS}",
            # CUDA launches of one wrapper call, and each kernel's device
            # ms per call, by name, from a short profiler pass
            "cuda_launches_per_call": (None if stages is None
                                       else sum(v["count"] for v in stages.values()) / 5),
            "stages": stages,
            "launch_floor_ms": floor_ms,
        })

        # loops ① and ②: the decoded chunk, into states with some history
        _, dense, sparse, valid = dops.decode(buf, hex_table, **kw)
        rows, n_cols = sparse.shape
        n_dense = dense.shape[1]
        col_base = torch.arange(n_cols, device=dev)[None, :]
        for tag, vr in RANGES.items():
            base = vocab_lib.VocabState.init(n_cols, vr, track_counts=True, device=dev)
            for c in data["utf8_chunks"][1:3]:
                b = dops.decode(torch.from_numpy(c).to(dev), hex_table, **kw)
                base = ops.fused_vocab_update(base, b[2], b[3], use_kernel=False)
            modded = as_u32(sparse) % vr  # int64 [rows, n_cols]
            for track, name in ((False, "fused_genvocab"), (True, "fused_genvocab_slabs")):
                def fresh(rows_seen):
                    return vocab_lib.VocabState(
                        base.first_pos.clone(),
                        torch.tensor(rows_seen, dtype=torch.int32, device=dev),
                        base.counts.clone() if track else None)

                # the state's own offset, and three rows below the ceiling
                # (on the CPU the wrapper's host-side ceiling guard raises)
                offsets = [int(base.rows_seen)] + ([] if self.rehearse else [vocab_lib.NEVER - 3])
                for rows_seen in offsets:
                    got = fvops.fused_update(fresh(rows_seen), sparse, valid)
                    want = fresh(rows_seen)
                    want_seen = fvref.fused_genvocab(
                        want.first_pos, want.counts, sparse, valid, want.rows_seen)
                    self.sync()
                    what = f"{name} V={vr} rows_seen={rows_seen}"
                    expect(torch.equal(got.first_pos, want.first_pos), f"{what}: first_pos differs")
                    expect(torch.equal(got.rows_seen, want_seen), f"{what}: rows_seen differs")
                    if track:
                        expect(torch.equal(got.counts, want.counts), f"{what}: counts differ")
                st = fresh(int(base.rows_seen))
                pos = vocab_lib.positions(st.rows_seen, rows, valid)
                live = (pos < vocab_lib.NEVER)[:, None].expand(rows, n_cols)
                state_touched = int(torch.unique((col_base * vr + modded)[live]).numel())
                # valid flags in, the live rows' hashes in (the kernel skips an
                # invalid row before it reads them), rows_seen in and out, each
                # touched slot of each plane read and written once
                planes = 2 if track else 1
                live_rows = int(live.any(1).sum())
                b_ms, b_by = bound(
                    live_rows * n_cols * 4 + rows + 8 + state_touched * 8 * planes,
                    4 * live_rows * n_cols)
                idx_t = modded.t().contiguous()
                src = pos[None, :].expand_as(idx_t).contiguous()
                rec = {
                    "max_abs_err": 0,
                    **self.times(
                        lambda: fvops.fused_update(st, sparse, valid),
                        lambda: fvref.fused_genvocab(
                            st.first_pos, st.counts, sparse, valid, st.rows_seen),
                        lambda: st.first_pos.scatter_reduce_(1, idx_t, src, reduce="amin")),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_call": "Tensor.scatter_reduce_(amin) on pre-modded indices",
                    "shape": f"[{rows}, {n_cols}] into [{n_cols}, {vr}]",
                    # ms above is on a state this chunk has already filled;
                    # a fresh state (every slot NEVER) makes every first
                    # sighting an atomic, as a chunk sees early in a run
                    "fresh_ms": self.fresh_ms(vocab_lib, n_cols, vr, track, base.rows_seen,
                                              sparse, valid, fvops.fused_update),
                    "launch_floor_ms": floor_ms,
                }
                if not track:
                    rec["binary"] = self.binary_genvocab(data, vocab_lib, fvops, fvref, base, vr)
                record(f"{name}@{tag}", rec)

            # loop ② through a vocabulary finalized from that state
            vocab = vocab_lib.finalize(base)
            ids_k, dense_k = fxops.fused_transform(vocab, sparse, dense)
            ids_r, dense_r = fxref.fused_transform(vocab.table, sparse, dense)
            mod_k, dmod_k = fxops.fused_mod_dense(sparse, dense, vocab_range=vr)
            mod_r, _ = fxref.fused_mod_dense(sparse, dense, vr)
            self.sync()
            expect(torch.equal(ids_k, ids_r), f"fused_transform V={vr}: ids differ")
            expect(torch.equal(mod_k, mod_r), f"fused_mod_dense V={vr}: modded differ")
            slots = col_base * vr + modded
            touched = int(torch.unique(slots).numel())
            # the bound counts 4 bytes a touched slot; the 32-byte sectors of
            # 8 slots that hold them are recorded beside it (the card reads
            # sectors from device memory, but at 5K the table sits in L2)
            sectors = int(torch.unique(slots // 8).numel())
            idx_t = modded.t().contiguous()
            io_bytes = rows * (n_cols + n_dense) * 4 * 2
            for name, dk, fn, plain, table_bytes, lib in (
                ("fused_transform", dense_k,
                 lambda: fxops.fused_transform(vocab, sparse, dense),
                 lambda: fxref.fused_transform(vocab.table, sparse, dense), touched * 4,
                 lambda: torch.gather(vocab.table, 1, idx_t)),
                ("fused_mod_dense", dmod_k,
                 lambda: fxops.fused_mod_dense(sparse, dense, vocab_range=vr),
                 lambda: fxref.fused_mod_dense(sparse, dense, vr), 0, None),
            ):
                expect(torch.allclose(dk, dense_r, rtol=1e-6, atol=0),
                       f"{name} V={vr}: dense beyond rtol 1e-6")
                b_ms, b_by = bound(io_bytes + table_bytes, rows * (3 * n_cols + 20 * n_dense))
                rec = {
                    "max_abs_err": float((dk - dense_r).abs().max()),
                    **self.times(fn, plain, lib),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": f"sparse [{rows}, {n_cols}], dense [{rows}, {n_dense}], V={vr}",
                }
                if lib:
                    rec["library_call"] = "torch.gather on pre-modded indices (ids only)"
                    rec["table_sectors"] = sectors
                    rec["bound_ms_by_sectors"] = bound(io_bytes + sectors * 32, 0)[0]
                rec["launch_floor_ms"] = floor_ms
                record(f"{name}@{tag}", rec)

            # the bytes-in loops ① and ②: the 1 MiB chunk and the hostile
            # chunks, into that state (at its own offset and three rows below
            # the ceiling) and through that vocabulary
            fkw = dict(n_fields=sch.n_fields, hex_start=1 + sch.n_dense)
            err = 0.0
            for b, max_rows, what in byte_chunks:
                for rows_seen in offsets:
                    def fresh_state():
                        return vocab_lib.VocabState(
                            base.first_pos.clone(),
                            torch.tensor(rows_seen, dtype=torch.int32, device=dev))

                    got = fdvops.fused_decode_update(fresh_state(), b, max_rows=max_rows, **fkw)
                    want = fdvref.fused_decode_genvocab(fresh_state(), b, max_rows=max_rows,
                                                        **fkw)
                    self.sync()
                    where = f"fused_decode_genvocab V={vr} rows_seen={rows_seen}, {what}"
                    expect(torch.equal(got.first_pos, want.first_pos),
                           f"{where}: first_pos differs")
                    expect(torch.equal(got.rows_seen, want.rows_seen),
                           f"{where}: rows_seen differs")
                got = fdxops.fused_decode_transform(vocab, b, max_rows=max_rows, **fkw)
                want = fdxref.fused_decode_transform(vocab, b, max_rows=max_rows, **fkw)
                self.sync()
                where = f"fused_decode_transform V={vr}, {what}"
                for i, name in ((0, "label"), (2, "ids"), (3, "valid")):
                    expect(torch.equal(got[i], want[i]), f"{where}: {name} differs")
                expect(torch.allclose(got[1], want[1], rtol=1e-6, atol=0),
                       f"{where}: dense beyond rtol 1e-6")
                err = max(err, float((got[1] - want[1]).abs().max()))
            st = vocab_lib.VocabState(base.first_pos.clone(), base.rows_seen.clone())
            n = buf.numel()
            # the chunk in, rows_seen in and out, each state slot that the
            # decoded chunk above touched read and written once
            b_ms, b_by = bound(n + 8 + state_touched * 8, 12 * n + 4 * rows * n_cols)
            record(f"fused_decode_genvocab@{tag}", {
                "max_abs_err": 0,
                **self.times(
                    lambda: fdvops.fused_decode_update(st, buf, max_rows=MAX_ROWS, **fkw),
                    lambda: fdvref.fused_decode_genvocab(st, buf, max_rows=MAX_ROWS, **fkw),
                    plain_reps=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"{n} B chunk, max_rows {MAX_ROWS}, into [{n_cols}, {vr}]",
            })
            # the chunk in, each touched table slot read once, the label,
            # dense, ids and valid outputs written once
            out_bytes = MAX_ROWS * (4 + 4 * n_dense + 4 * n_cols + 1)
            b_ms, b_by = bound(n + touched * 4 + out_bytes,
                               12 * n + rows * (3 * n_cols + 20 * n_dense))
            record(f"fused_decode_transform@{tag}", {
                "max_abs_err": err,
                **self.times(
                    lambda: fdxops.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw),
                    lambda: fdxref.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw),
                    plain_reps=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"{n} B chunk, max_rows {MAX_ROWS}, table [{n_cols}, {vr}]",
            })

            # the per-op kernels of the crossed plan's use_kernels route, on
            # its 27 vocab columns (the 26 sparse and the cross of columns 0
            # and 1): the chunk's modded values (with repeated keys), its
            # positions (NEVER on the padding rows), into a state with some
            # history (at its own offset and three rows below the ceiling)
            def crossed(sp):
                return torch.cat([sp, ops.hash_cross(sp[:, 0], sp[:, 1])[:, None]], dim=1)

            modded27 = ops.positive_modulus(crossed(sparse), vr)
            n27 = modded27.shape[1]
            mt = modded27.t()
            base27 = vocab_lib.VocabState.init(n27, vr, track_counts=True, device=dev)
            for c in data["utf8_chunks"][1:3]:
                b = dops.decode(torch.from_numpy(c).to(dev), hex_table, **kw)
                base27 = ops.fused_vocab_update(base27, crossed(b[2]), b[3], use_kernel=False)
            for track in (False, True):
                for rows_seen in offsets:
                    def fresh27():
                        return vocab_lib.VocabState(
                            base27.first_pos.clone(),
                            torch.tensor(rows_seen, dtype=torch.int32, device=dev),
                            base27.counts.clone() if track else None)

                    got = vops.genvocab_update(fresh27(), modded27, valid)
                    want = fresh27()
                    pos = vocab_lib.positions(want.rows_seen, rows, valid)
                    want_seen = vocab_lib.advance_rows_seen(
                        want.rows_seen, valid.to(torch.int32).sum())
                    self.sync()
                    what = f"genvocab V={vr} counts={track} rows_seen={rows_seen}"
                    expect(torch.equal(got.first_pos, vref.genvocab(want.first_pos, mt, pos)),
                           f"{what}: first_pos differs")
                    expect(torch.equal(got.rows_seen, want_seen), f"{what}: rows_seen differs")
                    if track:
                        expect(torch.equal(got.counts, vref.genvocab_counts(want.counts, mt, pos)),
                               f"{what}: counts differ")
            st = vocab_lib.VocabState(base27.first_pos.clone(), base27.rows_seen.clone())
            pos = vocab_lib.positions(st.rows_seen, rows, valid)
            slots27 = torch.arange(n27, device=dev)[None, :] * vr + modded27
            live = (pos < vocab_lib.NEVER)[:, None].expand(rows, n27)
            touched27 = int(torch.unique(slots27[live]).numel())
            idx_t = mt.to(torch.int64).contiguous()
            src = pos[None, :].expand_as(idx_t).contiguous()
            p = _build.ptr

            def genvocab_kernel():
                """The kernel alone, on the positions made above (the
                wrapper also computes them and the new rows_seen)."""
                if self.rehearse:
                    return vops.genvocab_update(st, modded27, valid)
                vops.KERNEL_GENVOCAB.launch(
                    dev, p(st.first_pos), None, p(modded27), p(pos), rows, n27, vr)

            wrapper = self.time_ms(lambda: vops.genvocab_update(st, modded27, valid))
            # positions in, the live rows' modded values in (the kernel skips a
            # NEVER row before it reads them), each touched state slot read
            # and written once; a compare and a min per live cell
            live_rows = int(live.any(1).sum())
            b_ms, b_by = bound(live_rows * n27 * 4 + rows * 4 + touched27 * 8,
                               2 * live_rows * n27)
            record(f"genvocab@{tag}", {
                "max_abs_err": 0,
                **self.times(genvocab_kernel, lambda: vref.genvocab(st.first_pos, mt, pos),
                             lambda: st.first_pos.scatter_reduce_(1, idx_t, src, reduce="amin")),
                "wrapper_ms": wrapper["device_ms"], "wrapper_call_ms": wrapper["call_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_call": "Tensor.scatter_reduce_(amin) on the transposed int64 indices",
                "shape": f"modded [{rows}, {n27}] into [{n27}, {vr}]",
            })
            vocab27 = vocab_lib.finalize(base27)
            ids_k = vops.apply_vocab(vocab27.table, modded27)
            self.sync()
            expect(torch.equal(ids_k, vref.apply_vocab(vocab27.table, mt).t()),
                   f"apply_vocab V={vr}: ids differ")
            # modded values in, ids out, each touched table slot read once
            b_ms, b_by = bound(rows * n27 * 8 + int(torch.unique(slots27).numel()) * 4,
                               2 * rows * n27)
            record(f"apply_vocab@{tag}", {
                "max_abs_err": 0,
                **self.times(lambda: vops.apply_vocab(vocab27.table, modded27),
                             lambda: vref.apply_vocab(vocab27.table, mt).t().contiguous(),
                             lambda: torch.gather(vocab27.table, 1, idx_t)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_call": "torch.gather on the transposed int64 indices (the same function)",
                "shape": f"modded [{rows}, {n27}], table [{n27}, {vr}]",
            })
            self.embedding_kernels(record, data, tag, vocab, kw)

        # the crossed plan's canonical dense group (dense columns 1-12 of the
        # chunk), with int32 extremes, and the same values as f32
        d12 = dense[:, 1:].clone()
        d12[0, :6] = torch.tensor([-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1], dtype=torch.int32)
        err = 0.0
        for x in (d12, d12.to(torch.float32)):
            got, want = dxops.dense_transform(x), dxref.dense_transform(x)
            self.sync()
            expect(torch.allclose(got, want, rtol=1e-6, atol=0),
                   f"dense_transform {x.dtype}: beyond rtol 1e-6")
            err = max(err, float((got - want).abs().max()))
        n = d12.numel()
        b_ms, b_by = bound(n * 8, 20 * n)
        record("dense_transform", {
            "max_abs_err": err,
            **self.times(lambda: dxops.dense_transform(d12), lambda: dxref.dense_transform(d12)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"int32 [{d12.shape[0]}, {d12.shape[1]}]",
        })
        return records

    def embedding_kernels(self, record, data, tag: str, vocab, kw) -> None:
        """The DLRM's embedding gather and its gradient at the train phase's
        shapes: tables [26, V, 64], ids [4096, 26] (Piper's ordinals of the
        feed's first chunks through ``vocab``, and a copy with ids -1, V and
        V+7), the output gradient [4096, 26, 64]."""
        torch, np, dev = self.torch, self.np, self.dev
        from repro_torch.core import schema as schema_lib
        from repro_torch.kernels.decode_utf8 import ops as dops
        from repro_torch.kernels.embedding_bag import ops as ebops, ref as ebref
        from repro_torch.kernels.fused_xform import ops as fxops

        batch = REHEARSAL_TRAIN_BATCH if self.rehearse else TRAIN_BATCH
        hex_table = schema_lib.CRITEO.field_is_hex()
        rows = []
        for c in data["utf8_chunks"]:
            b = dops.decode(torch.from_numpy(c).to(dev), hex_table, **kw)
            rows.append(fxops.fused_transform(vocab, b[2], b[1])[0][b[3]])
            if sum(len(r) for r in rows) >= batch:
                break
        ids = torch.cat(rows)[:batch].contiguous()
        # (a rehearsal stands a smaller table in for 1M; Piper's ordinals
        # stay below the feed's 2^14 distinct values per column)
        n_cols, dim = ids.shape[1], 64
        vr = REHEARSAL_RANGES[tag] if self.rehearse else vocab.vocab_range
        gen = torch.Generator(dev).manual_seed(7)
        tables = torch.randn((n_cols, vr, dim), generator=gen, device=dev) * dim**-0.5
        grad_out = torch.randn((batch, n_cols, dim), generator=gen, device=dev)
        odd = ids.clone()
        odd[0, :3] = torch.tensor([-1, vr, vr + 7], dtype=torch.int32)

        for what, x in (("Piper's ids", ids), ("ids -1, V, V+7", odd)):
            got = ebops.embedding_gather(tables, x)
            self.sync()
            expect(torch.equal(got, ebref.embedding_gather(tables, x)),
                   f"embedding_gather V={vr}, {what}: differs from the plain version")
        col = torch.arange(n_cols, device=dev)
        flat = ebref.clamp_ids(ids, vr) + col * vr
        touched = int(torch.unique(flat).numel())
        # ids in, each distinct (column, id) row read once, the output written once
        b_ms, b_by = bound(batch * n_cols * 4 + touched * dim * 4 + batch * n_cols * dim * 4, 0)
        table2d = tables.view(n_cols * vr, dim)
        record(f"embedding_gather@{tag}", {
            "max_abs_err": 0,
            **self.times(lambda: ebops.embedding_gather(tables, ids),
                         lambda: ebref.embedding_gather(tables, ids),
                         lambda: torch.nn.functional.embedding(flat, table2d)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_call": "F.embedding on clamped ids + c·V (the same function)",
            "shape": f"tables [{n_cols}, {vr}, {dim}], ids [{batch}, {n_cols}]",
        })
        del table2d

        # the gradient: against the float64 plain version within the float32
        # bound (n-1)·2^-24·Σ|terms| per element (n: most rows into one
        # table row), dropped ids included; two launches, the same bits
        err = 0.0
        for what, x in (("Piper's ids", ids), ("ids -1, V, V+7", odd)):
            got = ebops.embedding_gather_backward(grad_out, x, vr)
            again = ebops.embedding_gather_backward(grad_out, x, vr)
            self.sync()
            expect(torch.equal(got, again),
                   f"embedding_gather_backward V={vr}, {what}: two launches differ")
            del again
            want = ebref.embedding_gather_backward(grad_out, x, vr, dtype=torch.float64)
            n = max(int(torch.unique(ebref.wrap_ids(x[:, c], vr), return_counts=True)[1].max())
                    for c in range(n_cols))
            delta = got.double()
            del got
            delta.sub_(want).abs_()
            del want
            limit = ebref.embedding_gather_backward(grad_out.abs(), x, vr, dtype=torch.float64)
            limit.mul_(max(n - 1, 1) * 2.0**-24)
            expect(bool((delta <= limit).all()),
                   f"embedding_gather_backward V={vr}, {what}: beyond (n-1)·2^-24·Σ|terms|")
            err = max(err, float(delta.max()))
            del delta, limit
        rows_flat = (ebref.wrap_ids(ids, vr) + col * vr).reshape(-1)
        grad2d = grad_out.view(-1, dim)
        # the output gradient and ids in, the whole dense gradient written once
        b_ms, b_by = bound(batch * n_cols * (dim + 1) * 4 + n_cols * vr * dim * 4,
                           batch * n_cols * dim)
        record(f"embedding_gather_backward@{tag}", {
            "max_abs_err": err,
            **self.times(
                lambda: ebops.embedding_gather_backward(grad_out, ids, vr),
                lambda: ebref.embedding_gather_backward(grad_out, ids, vr),
                lambda: torch.zeros((n_cols * vr, dim), device=dev).index_add_(
                    0, rows_flat, grad2d),
                plain_reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            # zeroing, sort and sum apart: device ms per call of each kernel
            # and memset the call runs
            "stages": self.stages(lambda: ebops.embedding_gather_backward(grad_out, ids, vr)),
            "library_call": "torch.zeros(C·V, D).index_add_ on ids + c·V (atomics: "
                            "not deterministic)",
            "tolerance": "(n-1)·2^-24·Σ|terms| per element against float64, n = "
                         f"{n} rows into the hottest table row",
            "shape": f"grad_out [{batch}, {n_cols}, {dim}] into [{n_cols}, {vr}, {dim}]",
        })

    # -- phase 3 -------------------------------------------------------- #
    def golden(self) -> None:
        """fused_small.npz on the decoded route and on the use_kernels route
        (the fused hints off), and decode_fused_small.npz on the bytes-in
        route."""
        np = self.np
        from repro_torch.core import pipeline as P
        from repro_torch.data import synth

        unfused_kernels = {"use_kernels": True, "use_fused_kernel": False,
                           "use_fused_vocab": False}
        for name, route in (("fused_small", {}), ("fused_small", unfused_kernels),
                            ("decode_fused_small", {"use_fused_decode": True})):
            g = np.load(ROOT / "tests" / "goldens" / f"{name}.npz")
            cb = int(g["chunk_bytes"])
            pipe = P.PiperPipeline(P.PipelineConfig(
                chunk_bytes=cb, max_rows_per_chunk=int(g["max_rows_per_chunk"]),
                device=str(self.dev), **route))
            outs = list(pipe.run_stream(lambda: synth.chunk_stream(g["buf"], cb)))
            label = np.concatenate([o.label[o.valid].cpu().numpy() for o in outs])
            dense = np.concatenate([o.dense[o.valid].cpu().numpy() for o in outs])
            sparse = np.concatenate([o.sparse[o.valid].cpu().numpy() for o in outs])
            expect(np.array_equal(label, g["label"]), f"golden {name} {route}: labels differ")
            expect(np.array_equal(sparse, g["sparse"]), f"golden {name} {route}: sparse ids differ")
            expect(np.allclose(dense, g["dense"], rtol=1e-6, atol=0),
                   f"golden {name} {route}: dense beyond rtol 1e-6")
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(label, np.int32).tobytes())
            h.update(np.ascontiguousarray(sparse, np.int32).tobytes())
            expect(h.hexdigest() == str(g["digest"]), f"golden {name} {route}: digest differs")
            emit({"phase": "golden", "golden": name, "route": route,
                  "rows": int(label.shape[0]), "digest": h.hexdigest(), "ok": True})

    # -- phase 4 -------------------------------------------------------- #
    def _same(self, got, want, what: str) -> None:
        torch = self.torch
        expect(len(got) == len(want), f"{what}: {len(got)} chunks vs {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            for f in ("label", "sparse", "valid"):
                expect(torch.equal(getattr(a, f), getattr(b, f)), f"{what}: chunk {i} {f} differs")
            expect(torch.allclose(a.dense, b.dense, rtol=1e-6, atol=0),
                   f"{what}: chunk {i} dense beyond rtol 1e-6")
            expect(bool(torch.isfinite(a.dense).all()), f"{what}: chunk {i} dense not finite")

    def _flat(self, outs):
        from repro_torch.core import schema as schema_lib

        return schema_lib.ProcessedBatch(**{
            f: self.torch.cat([getattr(o, f) for o in outs])
            for f in ("label", "dense", "sparse", "valid")})

    def main_path(self, data, tag: str, vocab_range: int) -> dict:
        """One vocab range's main path with its launches counted, every run
        held to the unfused chain of its plan. Returns kernel → launches."""
        torch, np = self.torch, self.np
        from repro_torch.core import pipeline as P, plan as plan_lib
        from repro_torch.core import schema as schema_lib, vocab as vocab_lib
        from repro_torch.data import loader, synth

        kernels = counters()
        launches = dict.fromkeys(kernels, 0)

        def counted(fn):
            """Run one piece of the main path, every counter at 0 before it."""
            reset_counters(kernels)
            self.sync()
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            seconds = time.perf_counter() - t0
            got = {name: k.launches for name, k in kernels.items()}
            for name, n in got.items():
                launches[name] += n
            return out, seconds, {k: v for k, v in got.items() if v}

        sch = dataclasses.replace(schema_lib.CRITEO, vocab_range=vocab_range)
        kern = P.PipelineConfig(schema=sch, device=str(self.dev))
        oracle = dataclasses.replace(kern, use_fused_kernel=False, use_fused_vocab=False)
        crossed = plan_lib.crossed_criteo(sch)
        per_op = {"plan": crossed, "use_kernels": True, "use_fused_kernel": False,
                  "use_fused_vocab": False}
        # route → (feed, config fields, the loop-① and loop-② kernels each
        # chunk launches besides decode). The decoded utf8 route, the
        # bytes-in route and the binary feed run the default plan; the
        # crossed plan (27 vocab columns, a bucketized dense column) runs on
        # the per-op kernels of use_kernels (with use_fused_decode=True on
        # the utf8 feed, which must not take the bytes-in route) and on the
        # default hints (the fused kernels).
        routes = {
            "utf8": ("utf8", {}, ("fused_genvocab",), ("fused_transform",)),
            "utf8_bytes_in": ("utf8", {"use_fused_decode": True},
                              ("fused_decode_genvocab",), ("fused_decode_transform",)),
            "binary": ("binary", {}, ("fused_genvocab",), ("fused_transform",)),
            "crossed_utf8_kernels": ("utf8", {**per_op, "use_fused_decode": True},
                                     ("genvocab",), ("apply_vocab", "dense_transform")),
            "crossed_utf8_fused": ("utf8", {"plan": crossed},
                                   ("fused_genvocab",), ("fused_transform",)),
            "crossed_binary_kernels": ("binary", per_op,
                                       ("genvocab",), ("apply_vocab", "dense_transform")),
            "crossed_binary_fused": ("binary", {"plan": crossed},
                                     ("fused_genvocab",), ("fused_transform",)),
        }
        result = {"phase": "main", "schema": tag, "vocab_range": vocab_range}
        if not self.rehearse:
            torch.cuda.reset_peak_memory_stats()
        oracles = {}  # (feed, plan) → the unfused chain's state and outputs
        uses = {}
        for feed, fields, _, _ in routes.values():
            key = (feed, fields.get("plan"))
            uses[key] = uses.get(key, 0) + 1
        for route, (feed, fields, kernels1, kernels2) in routes.items():
            if feed == "utf8":
                chunks, n_rows = data["utf8_chunks"], data["utf8_rows"]
                stacked = np.stack(chunks)
                sizes = [7, 1, 30, 1000, 5000]
                payloads = list(synth.request_payloads(data["utf8_buf"], None, sizes))
            else:
                n_rows = data["binary_rows"]
                stacked = loader.BinaryChunkFeed(data["binary"], MAX_ROWS).flat_chunks()
                chunks = [{k: v[i] for k, v in stacked.items()}
                          for i in range(len(stacked["label"]))]
                sizes = [7, 1, 30, 1000, 5000]
                starts = np.cumsum([0] + sizes[:-1])
                payloads = [{k: data["binary"][k][r0:r0 + m] for k in ("label", "dense", "sparse")}
                            for r0, m in zip(starts, sizes)]
            pipe = P.PiperPipeline(dataclasses.replace(kern, input_format=feed, **fields))
            n = len(chunks)
            state, s1, l1 = counted(lambda: pipe.build_state_stream(chunks))
            vocab, s_fin, _ = counted(lambda: vocab_lib.finalize(state))
            outs, s2, l2 = counted(lambda: list(pipe.transform_stream(vocab, chunks)))
            key = (feed, fields.get("plan"))
            if key not in oracles:
                pipe_o = P.PiperPipeline(dataclasses.replace(
                    oracle, input_format=feed, plan=fields.get("plan")))
                state_o = pipe_o.build_state_stream(chunks)
                oracles[key] = (state_o, list(pipe_o.transform_stream(
                    vocab_lib.finalize(state_o), chunks)))
            state_o, outs_o = oracles[key]
            uses[key] -= 1
            if not uses[key]:
                del oracles[key]
            expect(torch.equal(state.first_pos, state_o.first_pos),
                   f"{tag} {route}: loop ① state differs")
            expect(torch.equal(state.rows_seen, state_o.rows_seen),
                   f"{tag} {route}: rows_seen differs")
            self._same(outs, outs_o, f"{tag} {route} run_stream")
            table = self._flat(outs)
            del outs, outs_o, state_o
            scan, s_scan, l_scan = counted(lambda: pipe.run_scan(stacked))
            self._same([P.flatten_processed(scan)], [table],
                       f"{tag} {route} run_scan vs run_stream")
            del scan

            # a few requests served with the frozen vocabulary, held to the
            # offline table's rows
            step = pipe.frozen_transform(vocab)
            served, s_serve, l_serve = counted(lambda: [step(p) for p in payloads])
            offline = {f: getattr(table, f)[table.valid] for f in ("label", "dense", "sparse")}
            row0 = 0
            for m, out in zip(sizes, served):
                v = out.valid
                expect(int(v.sum()) == m, f"{tag} {route} serve: {int(v.sum())} rows, sent {m}")
                for f in ("label", "sparse"):
                    expect(torch.equal(getattr(out, f)[v], offline[f][row0:row0 + m]),
                           f"{tag} {route} serve: {f} differs from the offline table")
                expect(torch.allclose(out.dense[v], offline["dense"][row0:row0 + m],
                                      rtol=1e-6, atol=0),
                       f"{tag} {route} serve: dense differs from the offline table")
                row0 += m
            del table, offline
            if not self.rehearse:
                # each chunk (and each request) launches exactly the route's
                # kernels once per loop, plus one decode where the route
                # decodes, and nothing else
                decode = ("decode_scan",) if feed == "utf8" and route != "utf8_bytes_in" else ()

                def each(names, times_):
                    return {k: times_ for k in names}

                for what, got, want in (
                    ("loop ①", l1, each(decode + kernels1, n)),
                    ("loop ②", l2, each(decode + kernels2, n)),
                    ("run_scan", l_scan, {**each(decode, 2 * n), **each(kernels1 + kernels2, n)}),
                    ("serve", l_serve, each(decode + kernels2, len(sizes))),
                ):
                    expect(got == want, f"{tag} {route} {what}: launched {got}, expected {want}")
            # repeats of each loop for its spread, and the device's busy
            # share: its kernel and copy time in a profiled run over the
            # median wall time
            loop1 = lambda: pipe.build_state_stream(chunks)  # noqa: E731
            loop2 = lambda: list(pipe.transform_stream(vocab, chunks))  # noqa: E731
            rep1, rep2 = self.wall_seconds(loop1), self.wall_seconds(loop2)
            med1, med2 = statistics.median(rep1), statistics.median(rep2)
            busy1, busy2 = self.device_seconds(loop1), self.device_seconds(loop2)
            result[route] = {
                "rows": n_rows, "chunks": n,
                "vocab_columns": pipe.compiled.n_vocab_columns,
                "routes": {"loop1": pipe.compiled.vocab_route,
                           "loop2": pipe.compiled.xform_route,
                           "decode": [pipe.compiled.decode_vocab_route,
                                      pipe.compiled.decode_xform_route]},
                "loop1_s": s1, "loop1_repeat_s": rep1, "loop1_rows_per_s_median": n_rows / med1,
                "finalize_s": s_fin,
                "loop2_s": s2, "loop2_repeat_s": rep2, "loop2_rows_per_s_median": n_rows / med2,
                "loop1_device_busy_share": None if busy1 is None else busy1 / med1,
                "loop2_device_busy_share": None if busy2 is None else busy2 / med2,
                "run_scan_s": s_scan, "run_scan_rows_per_s": n_rows / s_scan,
                "loop1_launches_per_chunk": {k: v / n for k, v in l1.items()},
                "loop2_launches_per_chunk": {k: v / n for k, v in l2.items()},
                "run_scan_launches": l_scan,
                "serve_requests": len(sizes), "serve_s": s_serve, "serve_launches": l_serve,
            }

        # the count plane and a top-k vocabulary, on the utf8 feed
        chunks = data["utf8_chunks"]
        pipe = P.PiperPipeline(dataclasses.replace(kern, track_vocab_counts=True))
        pipe_o = P.PiperPipeline(dataclasses.replace(oracle, track_vocab_counts=True))
        k = vocab_range // 10
        state, s1, l1 = counted(lambda: pipe.build_state_stream(chunks))
        vocab, _, _ = counted(lambda: vocab_lib.finalize_topk(state, k))
        outs, s2, _ = counted(lambda: list(pipe.transform_stream(vocab, chunks)))
        state_o = pipe_o.build_state_stream(chunks)
        for f in ("first_pos", "counts", "rows_seen"):
            expect(torch.equal(getattr(state, f), getattr(state_o, f)),
                   f"{tag} counts: loop ① {f} differs")
        vocab_o = vocab_lib.finalize_topk(state_o, k)
        expect(torch.equal(vocab.table, vocab_o.table) and torch.equal(vocab.sizes, vocab_o.sizes),
               f"{tag} counts: finalize_topk differs")
        self._same(outs, list(pipe_o.transform_stream(vocab_o, chunks)),
                   f"{tag} counts+topk run_stream")
        result["utf8_counts_topk"] = {
            "k": k, "loop1_s": s1, "loop1_rows_per_s": data["utf8_rows"] / s1,
            "loop2_s": s2, "loop2_rows_per_s": data["utf8_rows"] / s2,
            "loop1_launches_per_chunk": {k: v / len(chunks) for k, v in l1.items()},
        }
        if not self.rehearse:
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["launches"] = launches
        emit(result)
        return launches


    # -- phase 5 -------------------------------------------------------- #
    def train(self, data, tag: str) -> dict:
        """Piper → DLRM training at one range, every train step's launches
        counted on its own. Returns kernel → launches over the phase's path
        (Piper's run_stream and the train steps). Prints what it measured,
        also when a check fails."""
        result = {"phase": "train", "range": tag}
        try:
            return self._train(data, tag, result)
        finally:
            emit(result)

    def _train(self, data, tag: str, result: dict) -> dict:
        torch, dev = self.torch, self.dev
        from repro_torch.configs import piper_dlrm
        from repro_torch.core import pipeline as P
        from repro_torch.models import dlrm
        from repro_torch.train import checkpoint, input_pipeline, optimizer, steps
        from repro_torch.train.tree import leaves, leaves_with_paths

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = {"5K": piper_dlrm.CONFIG_5K, "1M": piper_dlrm.CONFIG_1M}[tag]
        batch_rows, n_steps = TRAIN_BATCH, TRAIN_STEPS[tag]
        if self.rehearse:
            vr = REHEARSAL_RANGES[tag]
            cfg = dataclasses.replace(
                cfg, schema=dataclasses.replace(cfg.schema, vocab_range=vr),
                model=dataclasses.replace(cfg.model, vocab_range=vr))
            batch_rows, n_steps = REHEARSAL_TRAIN_BATCH, REHEARSAL_TRAIN_STEPS[tag]
        else:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        result.update(config=cfg.name, vocab_range=cfg.model.vocab_range,
                      batch_rows=batch_rows, steps=n_steps,
                      allow_tf32={"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                                  "cudnn": torch.backends.cudnn.allow_tf32})
        kernels = counters()
        launches = dict.fromkeys(kernels, 0)
        chunks = data["utf8_chunks"]

        seconds = result["seconds"] = {}
        t_lap = [time.perf_counter()]

        def lap(name):
            """Host seconds since the last lap, into result["seconds"]."""
            self.sync()
            now = time.perf_counter()
            seconds[name] = now - t_lap[0]
            t_lap[0] = now

        # Piper's two loops, default hints, on the utf8 feed
        pipe = P.PiperPipeline(cfg.pipeline_config(device=str(dev)))
        reset_counters(kernels)
        self.sync()
        t0 = time.perf_counter()
        outs = list(pipe.run_stream(lambda: iter(chunks)))
        self.sync()
        result["piper_s"] = time.perf_counter() - t0
        got = {k: v.launches for k, v in kernels.items() if v.launches}
        for k, v in got.items():
            launches[k] += v
        if not self.rehearse:
            n = len(chunks)
            want = {"decode_scan": 2 * n, "fused_genvocab": n, "fused_transform": n}
            expect(got == want, f"train {tag}: Piper launched {got}, expected {want}")
        result["piper_launches"] = got
        state = pipe.build_state_stream(chunks)  # loop ①'s state, for the checkpoint
        lap("piper")

        def fresh():
            gen = torch.Generator(dev).manual_seed(0)
            model = dlrm.DLRM(cfg.model, device=dev, generator=gen)
            return model, optimizer.adamw_init(model.params_tree())

        step = steps.make_tabular_train_step(dlrm.loss, optimizer.AdamWConfig())
        model, opt = fresh()
        lap("init")
        batches, losses, step_launches, events = [], [], [], []

        def mark():
            if not self.rehearse:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

        # the train loop: the loss read one step lagged, so the host queues
        # step i while the device finishes step i-1
        it = iter(input_pipeline.TrainInputPipeline(outs, batch_rows=batch_rows,
                                                    n_steps=n_steps))
        pending = None
        mark()
        for _ in range(n_steps):
            batch = next(it)
            batches.append(batch)
            reset_counters(kernels)
            metrics = step(model, opt, batch)
            got = {k: v.launches for k, v in kernels.items() if v.launches}
            step_launches.append(got)
            for k, v in got.items():
                launches[k] += v
            if pending is not None:
                losses.append(float(pending))
            pending = metrics["loss"]
            mark()
        losses.append(float(pending))
        lap("train_steps")
        if not self.rehearse:
            want = {"embedding_gather": 1, "embedding_gather_backward": 1}
            for i, got in enumerate(step_launches):
                expect(got == want, f"train {tag}: step {i} launched {got}, expected {want}")
            result["peak_memory_bytes_training"] = torch.cuda.max_memory_allocated()
        first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
        result.update(losses=losses, loss_first10_mean=first, loss_last10_mean=last,
                      launches_per_step=step_launches[0])
        if events:
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            med = statistics.median(step_ms[3:])
            result.update(step_ms=step_ms, ms_per_step_median=med,
                          rows_per_s=batch_rows / (med / 1e3))
        expect(all(math.isfinite(x) for x in losses), f"train {tag}: a loss is not finite")
        expect(last < first, f"train {tag}: loss did not fall ({first} → {last})")

        # one checkpoint, Piper's VocabState under extra, restored bit for bit
        final = [t.detach().clone() for t in leaves(model.params_tree()) + leaves(opt)] \
            if tag == "5K" else None
        root = ROOT / "build" / "train_ckpt" / tag
        shutil.rmtree(root, ignore_errors=True)
        tree = {"params": model.params_tree(), "opt": opt, "extra": {"vocab": state}}
        ckpt = checkpoint.AsyncCheckpointer(str(root), keep=1)
        t0 = time.perf_counter()
        ckpt.save_async(n_steps, tree)
        snapshot_s = time.perf_counter() - t0
        ckpt.wait()
        write_s = time.perf_counter() - t0 - snapshot_s
        expect(checkpoint.latest_step(str(root)) == n_steps, f"train {tag}: no checkpoint")
        t0 = time.perf_counter()
        back = checkpoint.restore(str(root), n_steps, tree, device=dev)
        self.sync()
        restore_s = time.perf_counter() - t0
        n_leaves = 0
        for (path, a), b in zip(leaves_with_paths(back), leaves(tree)):
            expect(torch.equal(a, b.detach()), f"train {tag}: checkpoint leaf "
                   f"{'/'.join(path)} differs after the round trip")
            n_leaves += 1
        del back
        result["checkpoint"] = {
            "leaves": n_leaves, "bytes": sum(t.numel() * t.element_size() for t in leaves(tree)),
            "snapshot_s": snapshot_s, "write_s": write_s, "restore_s": restore_s}
        shutil.rmtree(root)

        lap("checkpoint")

        # the device's busy share of one more step, profiled, and where its
        # device time goes
        prof = self.profile(lambda: step(model, opt, batches[-1]))
        if prof is not None and "ms_per_step_median" in result:
            busy_ms = sum(e["ms"] for e in prof)
            result["device_busy_share"] = busy_ms / result["ms_per_step_median"]
            result["profiled_step"] = {"device_launches": sum(e["count"] for e in prof),
                                       "top": prof[:10]}
        del model, opt, tree
        lap("profiled_step")

        if tag == "5K":
            self._cpu_agreement(cfg, fresh, step, batches, result)
            lap("cpu_agreement")
            # determinism: a second run from the same seed on the same batches
            model, opt = fresh()
            for batch in batches:
                step(model, opt, batch)
            self.sync()
            for i, (a, b) in enumerate(zip(leaves(model.params_tree()) + leaves(opt), final)):
                expect(torch.equal(a.detach(), b), f"train {tag}: a second run from the same "
                       f"seed ends with other bits in leaf {i}")
            result["deterministic"] = True
            del model, opt, final
            lap("second_run")
        if not self.rehearse:
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["launches"] = {k: v for k, v in launches.items() if v}
        return launches

    def _relu_inputs(self, model, batch):
        """The inputs of every ReLU of ``model``'s forward pass on ``batch``,
        flattened into one tensor."""
        torch = self.torch
        seen = []
        hooks = [layer.register_forward_hook(lambda mod, inp, out: seen.append(out.flatten()))
                 for mlp in (model.bottom, model.top) for layer in list(mlp)[:-1]]
        try:
            with torch.no_grad():
                model(batch["dense"], batch["sparse"])
        finally:
            for h in hooks:
                h.remove()
        return torch.cat(seen)

    def _cpu_agreement(self, cfg, fresh, step, batches, result: dict) -> None:
        """The first 5 steps on the card against the port's CPU path on the
        same weights, AdamW state and batches: before each step the CPU
        model takes the card's weights and state.

        Tolerances, float32 throughout (TF32 off). A pre-activation within
        rounding of 0 can fall on the other side of a ReLU on the card, and
        then every gradient below that ReLU moves by a discrete step (on an
        H100 at 5K, with one such flip: the two layers above the first ReLU
        agreed to 2e-7, the rest to 4e-5-1.5e-4). So each parameter's step-1
        gradient is held norm-wise, |Δ|₂ ≤ 1e-3·|g|₂, and entry-wise,
        max|Δ| ≤ 1e-3·max|g|, and the ReLU inputs whose sign differs are
        counted. Each step's loss (a mean of 4096 terms) and grad_norm
        within rtol 1e-4."""
        torch = self.torch
        from repro_torch.models import dlrm
        from repro_torch.train import optimizer, steps
        from repro_torch.train.tree import leaves, leaves_with_paths

        model, opt = fresh()
        cpu = dlrm.DLRM(cfg.model, device="cpu")
        cpu_opt = optimizer.adamw_init(cpu.params_tree())
        pairs = list(zip(leaves(cpu.params_tree()) + leaves(cpu_opt),
                         leaves(model.params_tree()) + leaves(opt)))
        grad_err, loss_err, norm_err = {}, [], []
        failures = []
        for i, batch in enumerate(batches[:5]):
            with torch.no_grad():
                for a, b in pairs:
                    a.copy_(b.cpu())
            cpu_batch = {k: v.cpu() for k, v in batch.items()}
            if i == 0:
                card_signs = self._relu_inputs(model, batch) > 0
                flips = int((card_signs.cpu() != (self._relu_inputs(cpu, cpu_batch) > 0)).sum())
                del card_signs
                _, got = steps.value_and_grad(dlrm.loss, model, batch)
                _, want = steps.value_and_grad(dlrm.loss, cpu, cpu_batch)
                for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
                    d = g.cpu() - w
                    err = {"max": float(d.abs().max()) / max(float(w.abs().max()), 1e-30),
                           "norm": float(d.norm()) / max(float(w.norm()), 1e-30)}
                    grad_err["/".join(path)] = err
                    if err["max"] > 1e-3 or err["norm"] > 1e-3:
                        failures.append(f"step-1 gradient of {'/'.join(path)}: {err}")
                del got, want
            gm = step(model, opt, batch)
            cm = step(cpu, cpu_opt, cpu_batch)
            for key, errs in (("loss", loss_err), ("grad_norm", norm_err)):
                err = abs(float(gm[key]) / float(cm[key]) - 1)
                errs.append(err)
                if err > 1e-4:
                    failures.append(f"step {i} {key}: rtol {err}")
        agreement = {"steps": 5, "step1_relu_sign_flips": flips, "step1_grad_rel_err": grad_err,
                     "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
        result["cpu_agreement"] = agreement
        expect(not failures, "train 5K: the card differs from the CPU beyond tolerance: "
               + "; ".join(failures))

    # -- phase 6 -------------------------------------------------------- #
    def serve(self, data) -> tuple[dict, dict]:
        """gemma-2b serving: the kernel against its plain version, two
        prefills with their launches counted, the engine. Returns (kernel
        records by entry name, kernel → launches per prefill tag). Prints
        what it measured, also when a check fails."""
        result = {"phase": "serve"}
        try:
            return self._serve(data, result)
        finally:
            emit(result)

    def _rel_l2(self, got, want) -> float:
        d = (got.float() - want.float()).norm()
        return float(d / want.float().norm().clamp_min(1e-30))

    def _segment_rel_l2(self, got, want) -> float:
        """The largest |Δ|₂ / |want|₂ over (batch, head, FLASH_SEGMENT_ROWS
        query rows) of two [B, H, S, D] outputs."""
        b, h, s, d = want.shape
        rows = min(FLASH_SEGMENT_ROWS, s)
        shape = (b, h, s // rows, rows * d)
        diff = (got.float() - want.float()).reshape(shape).norm(dim=-1)
        return float((diff / want.float().reshape(shape).norm(dim=-1).clamp_min(1e-30)).max())

    def _flash_checks(self, cfg, result: dict) -> dict:
        """The kernel against ``ref.mha`` at the layer's shapes; returns
        the largest bf16 error by (batch, seq)."""
        torch, dev = self.torch, self.dev
        from repro_torch.kernels.flash_attention import ops as faops, ref as faref

        b, s = 4, (4096 if not self.rehearse else 256)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen = torch.Generator(dev).manual_seed(11)
        cases = [  # (B, Hq, Hkv, S, dtype, causal, tolerance): the reference's
            (b, hq, hkv, s, torch.bfloat16, True, 2e-2),
            (b, hq, hkv, s, torch.float32, True, 2e-5),
            (1, hq, hq, s, torch.bfloat16, True, 2e-2),   # Hq == Hkv
            (b, hq, hkv, s, torch.bfloat16, False, 2e-2),  # not causal
        ]
        checks, errs = [], {}
        for bb, h, hk, ss, dtype, causal, tol in cases:
            q = torch.randn((bb, h, ss, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((bb, hk, ss, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((bb, hk, ss, d), generator=gen, device=dev).to(dtype)
            got = faops.flash_attention(q, k, v, causal=causal)
            self.sync()
            want = faref.mha(q, k, v, causal=causal)
            err = float((got.float() - want.float()).abs().max())
            rel, rel_tol = self._segment_rel_l2(got, want), FLASH_REL_L2[str(dtype)]
            shape = f"q [{bb}, {h}, {ss}, {d}], k/v [{bb}, {hk}, {ss}, {d}]"
            checks.append({"shape": shape, "dtype": str(dtype), "causal": causal,
                           "tolerance": tol, "max_abs_err": err,
                           "segment_rel_l2": rel, "segment_rel_l2_tolerance": rel_tol})
            expect(bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)),
                   f"flash_attention {shape} {dtype} causal={causal}: beyond {tol}")
            expect(rel <= rel_tol, f"flash_attention {shape} {dtype} causal={causal}: "
                   f"relative L2 {rel} over {FLASH_SEGMENT_ROWS} rows > {rel_tol}")
            if dtype == torch.bfloat16 and causal and hk == hkv:
                errs[(bb, ss)] = (err, rel)
            del q, k, v, got, want
        result["kernel_checks"] = checks
        return errs

    def _flash_record(self, cfg, batch: int, seq: int, errs) -> dict:
        """Times of the kernel, its plain version and SDPA at one prefill
        shape (random bf16 q, k, v). ``errs`` is (max abs, segment relative
        L2) from the checks at this shape; None at 32K, where the plain
        version runs one query head at a time (all 8 heads' float32 logits
        take 34 GB), and the errors are measured here.

        The kernel, SDPA and the plain version are timed alike, by CUDA
        events around calls back to back, the kernel and SDPA in the order
        kernel, SDPA, SDPA, kernel (the two runs of each averaged):
        profiler traces of such long loops lose launches.
        SDPA runs as the default dispatch (``library_ms``) and with each
        backend forced in turn (``sdpa_backends``); ``library_backend`` is
        the forced backend whose output the default call's equals bit for
        bit."""
        torch, dev = self.torch, self.dev
        from repro_torch.kernels.flash_attention import ops as faops, ref as faref

        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen = torch.Generator(dev).manual_seed(12)
        q = torch.randn((batch, hq, seq, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((batch, hkv, seq, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((batch, hkv, seq, d), generator=gen, device=dev).to(torch.bfloat16)
        per_head = errs is None
        err, rel = errs if errs else (0.0, 0.0)

        def plain():
            if per_head:
                return [faref.mha(q[:, h:h + 1], k, v) for h in range(hq)]
            return faref.mha(q, k, v)

        if per_head:
            got = faops.flash_attention(q, k, v)
            rel_tol = FLASH_REL_L2[str(torch.bfloat16)]
            for h in range(hq):
                want = faref.mha(q[:, h:h + 1], k, v)
                expect(bool(torch.allclose(got[:, h:h + 1].float(), want.float(), atol=2e-2,
                                           rtol=2e-2)),
                       f"flash_attention at [{batch}, {hq}, {seq}, {d}] head {h}: beyond 2e-2")
                err = max(err, float((got[:, h:h + 1].float() - want.float()).abs().max()))
                rel = max(rel, self._segment_rel_l2(got[:, h:h + 1], want))
                expect(rel <= rel_tol, f"flash_attention at [{batch}, {hq}, {seq}, {d}] head "
                       f"{h}: relative L2 {rel} over {FLASH_SEGMENT_ROWS} rows > {rel_tol}")
            del got, want
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def kernel():
            return faops.flash_attention(q, k, v)

        def library():
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)

        reps = 20 if seq <= 4096 else 5
        runs = {"ms": [], "library_ms": []}
        for key, fn in (("ms", kernel), ("library_ms", library), ("library_ms", library),
                        ("ms", kernel)):
            runs[key].append(self.event_ms(fn, reps))
        ms, lib_ms = (None if None in r else sum(r) / len(r) for r in runs.values())
        plain_ms = self.event_ms(plain, reps=2 if per_head else 5)
        ops = 4 * batch * hq * seq * seq * d // 2  # causal: half the products
        io = (2 * batch * hq + 2 * batch * hkv) * seq * d * 2
        b_ms, b_by = bound(io, ops, TENSOR_CORE_BF16_OPS_PER_S)
        backends, library_backend = self._sdpa_backends(library, reps, seq)
        rec = {
            "max_abs_err": err, "segment_rel_l2": rel, "kernel_route": faops.route(q.dtype, d),
            "ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms, "call_ms": ms,
            "ms_runs": runs["ms"], "library_ms_runs": runs["library_ms"],
            "ms_from": {"ms": "cuda_events", "plain_ms": "cuda_events",
                        "library_ms": "cuda_events"},
            "bound_ms": b_ms, "bound_by": b_by,
            "library_call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            "library_backend": library_backend, "sdpa_backends": backends,
            "plain": "ref.mha, one query head at a time" if per_head else "ref.mha",
            "shape": f"q [{batch}, {hq}, {seq}, {d}], k/v [{batch}, {hkv}, {seq}, {d}] bf16",
        }
        if ms:
            rec.update(tflops=ops / ms / 1e9, bound_share=b_ms / ms, vs_library=ms / lib_ms,
                       library_tflops=ops / lib_ms / 1e9)
        return rec

    def _sdpa_backends(self, library, reps: int, seq: int) -> tuple[dict, str | None]:
        """``library`` under torch.nn.attention.sdpa_kernel with each backend
        in turn: backend → its CUDA-event ms and the largest difference of
        its output from the default call's, or why it did not run. Returns
        that and the backend(s) whose output equals the default call's bit
        for bit, the one the default ran (None if none does; profiler traces
        of these calls came back empty). MATH materialises the [S, S]
        scores, so it runs only up to 8192 keys."""
        torch = self.torch
        from torch.nn.attention import SDPBackend, sdpa_kernel

        default = library()
        backends, ran = {}, []
        for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH"):
            if name == "MATH" and seq > 8192:
                backends[name] = {"not_run": f"{seq} keys: the [S, S] scores take too much memory"}
                continue
            try:
                with sdpa_kernel([getattr(SDPBackend, name)]):
                    out = library()
                    backends[name] = {"ms": self.event_ms(library, reps)}
            except RuntimeError as e:
                backends[name] = {"refused": str(e).strip().splitlines()[0][:160]}
                continue
            backends[name]["max_abs_diff_to_default"] = float(
                (out.float() - default.float()).abs().max())
            if torch.equal(out, default):
                ran.append(name)
            del out
        return backends, ("/".join(ran) if ran else None)

    def _serve(self, data, result: dict) -> tuple[dict, dict]:
        torch, np, dev = self.torch, self.np, self.dev
        from repro_torch.configs import gemma_2b
        from repro_torch.core import pipeline as P
        from repro_torch.data import loader
        from repro_torch.models import lm
        from repro_torch.serve import engine
        from repro_torch.train import steps

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = gemma_2b.SMOKE if self.rehearse else gemma_2b.CONFIG
        prefills = REHEARSAL_PREFILLS if self.rehearse else PREFILLS
        if not self.rehearse:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        result.update(config=cfg.name, layers=cfg.n_layers, params=cfg.param_count(),
                      allow_tf32={"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                                  "cudnn": torch.backends.cudnn.allow_tf32},
                      tolerance_rel_l2=SERVE_REL_L2)
        t_phase = time.perf_counter()
        kernels = counters()

        # the prompts: Piper's sparse ordinals of the 5K utf8 run
        pipe = P.PiperPipeline(P.PipelineConfig(device=str(dev)))
        outs = list(pipe.run_stream(lambda: iter(data["utf8_chunks"])))
        sparse = torch.cat([o.sparse[o.valid] for o in outs]).cpu().numpy()
        del outs

        errs = self._flash_checks(cfg, result)
        model = lm.LM(cfg, attn_impl="flash", device=dev)
        params = model.init(torch.Generator(dev).manual_seed(0))
        prefill = steps.make_prefill_step(model)
        records, launches, prefill_stats = {}, {}, {}
        for tag, (batch, seq) in prefills.items():
            tokens = torch.from_numpy(
                loader.PiperTokenBatches(sparse, cfg.vocab_size, batch, seq)(0)["tokens"]).to(dev)
            reset_counters(kernels)
            self.sync()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            self.sync()
            first_s = time.perf_counter() - t0
            got = {k: v.launches for k, v in kernels.items()}
            launches[tag] = got
            if not self.rehearse:
                want = dict.fromkeys(kernels, 0)
                want["flash_attention"] = cfg.n_layers
                expect(got == want, f"serve prefill {tag}: launched "
                       f"{ {k: v for k, v in got.items() if v} }, expected one flash_attention "
                       f"per layer ({cfg.n_layers})")
            expect(tuple(logits.shape) == (batch, cfg.vocab_size),
                   f"serve prefill {tag}: logits of shape {tuple(logits.shape)}")
            expect(bool(torch.isfinite(logits).all()), f"serve prefill {tag}: logits not finite")
            secs = self.wall_seconds(lambda: prefill(params, {"tokens": tokens}), n=3)
            med = statistics.median(secs)
            stats = {"first_s": first_s, "seconds": secs, "ms_per_call": med * 1e3,
                     "tokens_per_s": batch * seq / med,
                     "launches": {k: v for k, v in got.items() if v}}
            if tag == "B4xS4096":
                # the same prefill through the chunked route, the reference's
                chunked = steps.make_prefill_step(lm.LM(cfg, attn_impl="chunked", device=dev))
                want = chunked(params, {"tokens": tokens})
                rel = self._rel_l2(logits, want)
                stats.update(vs_chunked_rel_l2=rel,
                             vs_chunked_max_abs=float((logits.float() - want.float()).abs().max()),
                             vs_chunked_argmax_agree=float(
                                 (logits.argmax(-1) == want.argmax(-1)).float().mean()))
                expect(rel <= SERVE_REL_L2, f"serve prefill {tag}: flash and chunked routes "
                       f"differ by {rel} (relative L2) > {SERVE_REL_L2}")
                del want
            prof = self.profile(lambda: prefill(params, {"tokens": tokens}))
            if prof is not None:
                busy = sum(r["ms"] for r in prof)
                stats.update(device_busy_share=busy / stats["ms_per_call"],
                             profiled_call={"device_ms": busy, "top": prof[:8]})
            prefill_stats[tag] = stats
            del logits, tokens
            records[f"flash_attention@{tag}"] = self._flash_record(
                cfg, batch, seq, errs.get((batch, seq)))
        result["prefill"] = prefill_stats

        # the engine: 8 requests of Piper prompts, two waves of 4 slots
        e = ENGINE
        prompts = loader.PiperTokenBatches(sparse, cfg.vocab_size, e["requests"],
                                           e["prompt_len"])(1)["tokens"]
        eng = engine.ServeEngine(model, params, batch_slots=e["slots"], cache_len=e["cache_len"])
        reqs = [engine.Request(prompt=p.tolist(), max_new_tokens=e["new_tokens"])
                for p in prompts]
        seen = []  # (slot 0's position, its logits) of each step
        step = eng._step

        def spy(p, state, token, pos):
            out = step(p, state, token, pos)
            seen.append((int(eng.slot_pos[0]), out[0][0].detach().clone()))
            return out

        eng._step = spy
        for r in reqs:
            eng.submit(r)
        reset_counters(kernels)
        self.sync()
        t0 = time.perf_counter()
        eng.run_until_drained()
        self.sync()
        engine_s = time.perf_counter() - t0
        engine_launches = {k: v.launches for k, v in kernels.items() if v.launches}
        expect(all(r.done and len(r.generated) == e["new_tokens"] for r in reqs),
               f"serve engine: generated {[len(r.generated) for r in reqs]}, expected "
               f"{e['new_tokens']} each")
        n_tokens = sum(len(r.generated) for r in reqs)
        last = [lg for pos, lg in seen if pos == e["prompt_len"] - 1][0]  # request 0's
        want = prefill(params, {"tokens": torch.tensor(reqs[0].prompt, device=dev)[None]})[0]
        rel = self._rel_l2(last, want)
        result["engine"] = {
            **e, "steps": len(seen), "seconds": engine_s, "ms_per_step": engine_s / len(seen) * 1e3,
            "tokens_per_s": n_tokens / engine_s, "generated_tokens": n_tokens,
            "launches": engine_launches, "vs_prefill_rel_l2": rel, "vs_prefill_argmax_agree": bool(
                int(last.argmax()) == int(want.argmax())),
            "request0_generated": reqs[0].generated}
        expect(rel <= SERVE_REL_L2, f"serve engine: request 0's logits at its last prompt "
               f"position differ from the prefill step's by {rel} > {SERVE_REL_L2}")
        # where one more decode step's device time goes, and its busy share
        token = torch.zeros(e["slots"], dtype=torch.int32, device=dev)
        prof = self.profile(lambda: eng._step(params, eng.state, token, 0))
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            result["engine"].update(
                profiled_step={"device_ms": busy, "device_launches": sum(r["count"] for r in prof),
                               "top": prof[:8]},
                device_busy_share=busy / result["engine"]["ms_per_step"])
        if not self.rehearse:
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["seconds"] = time.perf_counter() - t_phase
        result["kernels"] = records
        return records, launches


def make_data(np, rows: dict) -> dict:
    """The main path's feeds, made from fixed seeds."""
    from repro_torch.data import synth

    rows_utf8, rows_binary = rows["utf8"], rows["binary"]
    t0 = time.perf_counter()
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows_utf8, seed=0))
    chunks = list(synth.chunk_stream(buf, CHUNK_BYTES))
    binary = synth.generate_binary(synth.SynthConfig(rows=rows_binary, seed=1))
    binary = {k: binary[k] for k in ("label", "dense", "sparse")}
    emit({"phase": "data", "utf8_rows": rows_utf8, "utf8_bytes": int(buf.size),
          "utf8_chunks": len(chunks), "binary_rows": rows_binary,
          "seconds": time.perf_counter() - t0})
    return {"utf8_buf": buf, "utf8_chunks": chunks, "utf8_rows": rows_utf8,
            "binary": binary, "binary_rows": rows_binary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,golden,main,train,serve")
    ap.add_argument("--out", default=None,
                    help="also write the kernel summary and every printed record to this JSON file")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a tiny size; prints no result")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t_start = time.perf_counter()
    smoke = Smoke(torch, np, args.rehearse)
    device = smoke.device()
    records, main_launches, train_launches, serve_launches = {}, None, None, None
    rows = REHEARSAL_ROWS if args.rehearse else ROWS
    data = make_data(np, rows) if phases & {"kernels", "main", "train", "serve"} else None
    if "kernels" in phases:
        records = smoke.kernels(data)
    if "golden" in phases:
        smoke.golden()
    if "main" in phases:
        main_launches = {tag: smoke.main_path(data, tag, vr) for tag, vr in RANGES.items()}
        if not args.rehearse:
            for name in PATH_KERNELS:
                expect(sum(m[name] for m in main_launches.values()) > 0,
                       f"main path: {name} was never launched")
    if "train" in phases:
        train_launches = {tag: smoke.train(data, tag) for tag in RANGES}
        if not args.rehearse:
            for name in TRAIN_KERNELS:
                expect(sum(m[name] for m in train_launches.values()) > 0,
                       f"train path: {name} was never launched")
    if "serve" in phases:
        serve_records, serve_launches = smoke.serve(data)
        records.update(serve_records)
        if not args.rehearse:
            for name in SERVE_KERNELS:
                expect(all(m[name] > 0 for m in serve_launches.values()),
                       f"serve path: {name} was not launched in every prefill")

    # launches on the paths: the main phase's and the train phase's per range,
    # the serve phase's per prefill
    paths = [m for m in (main_launches, train_launches, serve_launches) if m is not None]
    kernels = []
    for key, rec in records.items():
        name, _, tag = key.partition("@")
        replaces, source = TPU_KERNELS[name]
        n = None
        if paths:
            n = sum(m[name] for p in paths for t, m in p.items() if t == tag or not tag)
        kernels.append({
            "name": key, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": n,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "call_ms", "ms_from")},
            **{k: rec[k] for k in ("kernel_route", "tflops", "bound_share", "library_backend",
                                   "fresh_ms", "binary", "launch_floor_ms", "stages",
                                   "cuda_launches_per_call", "table_sectors", "bound_ms_by_sectors")
               if k in rec},
            "on_main_path": name in PATH_KERNELS + TRAIN_KERNELS + SERVE_KERNELS,
            "shape": rec["shape"],
        })
    seconds = time.perf_counter() - t_start
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": device, "kernels": kernels, "seconds": seconds,
                                   "records": RECORDS}, indent=1))
    print(f"chip_smoke: all phases passed in {seconds:.1f} s", flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal on the CPU; no result", flush=True)
        return 0
    emit({"kernels": kernels})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
