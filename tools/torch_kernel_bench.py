#!/usr/bin/env python3
"""The embedding gradient and loop ①'s fused GenVocab alone on one NVIDIA GPU.

    python3 tools/torch_kernel_bench.py [--src SRC] [--out results.json] [--label NAME]
    python3 tools/torch_kernel_bench.py --rehearse     # plumbing only, on the CPU

``--src`` is a ``src/`` directory that holds a ``repro_torch`` package
(default: this checkout's); run the script once per tree, in one command,
to compare two trees on one card (old, new, new, old). It prints, one JSON
object a line:

1. ``build``: the seconds to build ``csrc/embedding_bag.cu``,
   ``csrc/fused_vocab.cu`` and ``csrc/vocab.cu``, and for each kernel the
   registers and spill bytes ``ptxas -v`` reported;
2. ``check``: each kernel against its plain version, as the card tests
   hold it. ``embedding_gather_backward`` within (n-1)·2^-24·Σ|terms| of
   the float64 plain gradient and bit-identical across two launches, at
   the train path's shapes and at batches 4095, 4097, 8192 (V 10^6) and
   16384, one id in every row of a column, and dropped ids;
   ``fused_genvocab`` bit for bit on ``first_pos`` and ``rows_seen``: a
   fresh and a filled state, a Zipf chunk where one hash fills a quarter
   of the rows, an all-invalid chunk, a row count that is no multiple of
   32, and ``rows_seen`` at NEVER - 3;
3. ``time``: at the main path's shapes, each kernel's device time per
   call from torch.profiler (kernels and memsets by name, so the
   gradient's stages show apart) and its CUDA-event time per call, back
   to back after a warm-up. The gradient: grad_out f32 [4096, 26, 64],
   Piper-like ordinals [4096, 26] (a Zipf(1.3) feed's first sightings)
   into [26, V, 64], with ``torch.zeros().index_add_`` beside it.
   ``fused_genvocab``: sparse [16384, 26] with 3745 live rows (a 1 MiB
   utf8 chunk) or 16384 (a binary chunk), into a state filled by two
   earlier chunks ("warm") or all NEVER ("fresh", a new state for each
   call), with item 8's ``genvocab`` on the same chunk's modded values
   and positions, the host µs to issue one wrapper call, and an empty
   kernel's device time (the launch floor, where the tree has one).
   V = 5000 and 10^6.

The last line holds every record, with the card's name and power limit
(nvidia-smi). It exits non-zero if a check failed or there is no card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12
RANGES = {"5K": 5000, "1M": 1_000_000}
REHEARSAL_RANGES = {"5K": 5000, "1M": 20000}
N_COLS, DIM, BATCH, CHUNK_ROWS, UTF8_LIVE = 26, 64, 4096, 1 << 14, 3745
NEVER = 0x7FFFFFFF
# (n_cols, vocab, dim, batch, kind): kind "piper" (ordinals of a Zipf
# feed), "one" (one id in every row of each column), "drop" (Piper's ids
# with ids that are out of range after the wrap)
GRAD_CHECKS = [
    (26, 5000, 64, 4096, "piper"), (26, 5000, 64, 4096, "drop"), (26, 5000, 64, 4095, "piper"),
    (26, 5000, 64, 4097, "piper"), (26, 5000, 64, 16384, "piper"), (4, 5000, 64, 4096, "one"),
    (4, 5000, 64, 16384, "one"), (26, 1_000_000, 64, 4096, "drop"),
    (26, 1_000_000, 64, 8192, "piper"), (3, 11, 5, 40, "drop"), (4, 97, 8, 1, "piper"),
    (2, 7, 64, 33, "one"), (3, 9, 4, 0, "piper"),
]
REHEARSAL_GRAD_CHECKS = [c for c in GRAD_CHECKS if c[1] * c[3] <= 5000 * 4097]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_entries(log: str) -> dict:
    """Kernel (mangled name) → registers and spill bytes from ``ptxas -v``."""
    import re

    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif entry and "Used" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[entry]["registers"] = int(m.group(1))
    return usage


class Bench:
    def __init__(self, torch, np, dev, rehearse: bool):
        self.torch, self.np, self.dev, self.rehearse = torch, np, dev, rehearse

    def sync(self) -> None:
        if not self.rehearse:
            self.torch.cuda.synchronize()

    def event_ms(self, fn, reps: int, warmup: int = 3) -> float | None:
        """CUDA-event time per call, ``reps`` calls back to back."""
        if self.rehearse:
            fn()
            return None
        torch = self.torch
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

    def host_us(self, fn, calls: int = 200) -> float | None:
        """Host-clock µs to issue one call of ``fn``: ``calls`` calls with no
        synchronize between them (the wrapper's own cost while the card
        keeps up)."""
        if self.rehearse:
            fn()
            return None
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        self.torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    def device_ms(self, calls) -> dict | None:
        """One short torch.profiler pass over ``calls`` (callables, run in
        turn): device ms per call of each kernel or memset by name, its
        count, and ``total`` (per call, all names)."""
        if self.rehearse:
            for c in calls:
                c()
            return None
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        n = len(calls)
        for _ in range(3):  # a trace now and then comes back with no device events
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for c in calls:
                    c()
                torch.cuda.synchronize()
            by_name = {e.key[:60]: {"count": e.count, "ms": e.self_device_time_total / 1e3 / n}
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total}
            if by_name:
                break
        return {"by_name": by_name, "total": sum(v["ms"] for v in by_name.values())}

    # -- data ----------------------------------------------------------- #
    def chunk(self, seed: int):
        """A Zipf(1.3) chunk of raw hashes [16384, 26] (the synth feed's)."""
        from repro_torch.data import synth

        return synth.generate_binary(synth.SynthConfig(rows=CHUNK_ROWS, seed=seed))["sparse"]

    def ordinals(self, vocab: int, batch: int, seed: int = 5):
        """Piper-like ids [batch, 26]: per column, the rank of first sighting
        of each hash % V in a Zipf feed, as loop ① and finalize give them."""
        np = self.np
        sparse = self.chunk(seed)
        while sparse.shape[0] < batch:
            sparse = np.concatenate([sparse, self.chunk(seed + sparse.shape[0])])
        modded = sparse[:batch].view(np.uint32).astype(np.int64) % vocab
        ids = np.empty((batch, N_COLS), np.int32)
        for c in range(N_COLS):
            _, first, inverse = np.unique(modded[:, c], return_index=True, return_inverse=True)
            rank = np.empty(len(first), np.int64)
            rank[np.argsort(first, kind="stable")] = np.arange(len(first))
            ids[:, c] = rank[inverse]
        return ids

    # -- the gradient --------------------------------------------------- #
    def grad_inputs(self, n_cols, vocab, dim, batch, kind, seed=1):
        torch, np = self.torch, self.np
        if kind == "one":
            ids = np.full((batch, n_cols), vocab // 2, np.int32)
        elif n_cols == N_COLS and batch >= 1:
            ids = self.ordinals(vocab, batch)
        else:
            rng = np.random.default_rng(seed)
            ids = rng.integers(0, vocab, (batch, n_cols)).astype(np.int32)
            ids[rng.random((batch, n_cols)) < 0.3] = vocab // 2
        if kind == "drop" and batch >= 2 and n_cols >= 3:
            ids[0, :3] = [-1, vocab, vocab + 7]
            ids[batch - 1, :3] = [-vocab - 3, 2 * vocab, -2]
        gen = torch.Generator(self.dev).manual_seed(seed)
        grad_out = torch.randn((batch, n_cols, dim), generator=gen, device=self.dev)
        return torch.from_numpy(ids).to(self.dev), grad_out

    def check_grad(self, ebops, ebref, shape) -> dict:
        torch = self.torch
        n_cols, vocab, dim, batch, kind = shape
        ids, grad_out = self.grad_inputs(*shape)
        got = ebops.embedding_gather_backward(grad_out, ids, vocab)
        again = ebops.embedding_gather_backward(grad_out, ids, vocab)
        self.sync()
        same = bool(torch.equal(got, again))
        del again
        want = ebref.embedding_gather_backward(grad_out, ids, vocab, dtype=torch.float64)
        zeros_kept = bool(((want == 0) <= (got == 0)).all())
        n = max((int(torch.unique(ebref.wrap_ids(ids[:, c], vocab), return_counts=True)[1].max())
                 for c in range(n_cols)), default=1) if batch else 1
        delta = got.double()
        del got
        delta.sub_(want).abs_()
        del want
        limit = ebref.embedding_gather_backward(grad_out.abs(), ids, vocab, dtype=torch.float64)
        limit.mul_(max(n - 1, 1) * 2.0**-24)
        within = bool((delta <= limit).all())
        err = float(delta.max()) if delta.numel() else 0.0
        del delta, limit
        return {"kernel": "embedding_gather_backward", "shape": list(shape[:4]), "ids": kind,
                "hottest_run": n, "max_abs_err": err, "deterministic": same,
                "untouched_rows_zero": zeros_kept, "within_bound": within,
                "ok": same and zeros_kept and within}

    def time_grad(self, ebops, ebref, tag, vocab) -> dict:
        torch = self.torch
        ids, grad_out = self.grad_inputs(N_COLS, vocab, DIM, BATCH, "piper")
        col = torch.arange(N_COLS, device=self.dev)
        rows_flat = (ebref.wrap_ids(ids, vocab) + col * vocab).reshape(-1)
        grad2d = grad_out.view(-1, DIM)
        n_bytes = BATCH * N_COLS * (DIM + 1) * 4 + N_COLS * vocab * DIM * 4

        def kernel():
            return ebops.embedding_gather_backward(grad_out, ids, vocab)

        def library():
            return torch.zeros((N_COLS * vocab, DIM), device=self.dev).index_add_(
                0, rows_flat, grad2d)

        reps = 20 if vocab <= 5000 else 5
        rec = {"shape": f"grad_out [{BATCH}, {N_COLS}, {DIM}] into [{N_COLS}, {vocab}, {DIM}]",
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        kt, lt = [], []
        for fn, acc in ((kernel, kt), (library, lt), (library, lt), (kernel, kt)):
            acc.append(self.event_ms(fn, reps))
        stages = self.device_ms([kernel] * 5)
        lib_dev = self.device_ms([library] * 5)
        other, in_kernel = None, None
        if hasattr(ebops, "ZERO_IN_KERNEL_MAX_BYTES"):  # the other way to zero, in the same call
            limit = ebops.ZERO_IN_KERNEL_MAX_BYTES
            in_kernel = ebops.zero_in_kernel(N_COLS * vocab * DIM * 4)
            ebops.ZERO_IN_KERNEL_MAX_BYTES = 0 if in_kernel else 2**62
            try:
                other = self.device_ms([kernel] * 5)
            finally:
                ebops.ZERO_IN_KERNEL_MAX_BYTES = limit
        if not self.rehearse:
            rec.update(event_ms=sum(kt) / 2, event_ms_runs=kt, index_add_event_ms=sum(lt) / 2,
                       device_ms=stages["total"], stages=stages["by_name"],
                       index_add_device_ms=lib_dev["total"])
            rec["vs_index_add"] = rec["device_ms"] / max(rec["index_add_device_ms"], 1e-9)
            if other is not None:
                rec["zero_in_kernel"] = in_kernel
                rec["other_zeroing"] = {"device_ms": other["total"], "stages": other["by_name"]}
        return rec

    # -- fused_genvocab ------------------------------------------------- #
    def genvocab_case(self, fvops, fvref, vocab_lib, sparse, valid, first_pos, rows_seen):
        torch = self.torch

        def state():
            return vocab_lib.VocabState(first_pos.clone(),
                                        torch.tensor(rows_seen, dtype=torch.int32, device=self.dev))

        got = fvops.fused_update(state(), sparse, valid)
        want = state()
        seen = fvref.fused_genvocab(want.first_pos, None, sparse, valid, want.rows_seen)
        self.sync()
        return bool(torch.equal(got.first_pos, want.first_pos)) and bool(
            torch.equal(got.rows_seen, seen))

    def check_genvocab(self, fvops, fvref, vocab_lib) -> list:
        torch, np, dev = self.torch, self.np, self.dev
        records = []
        base = self.chunk(11)
        for vocab in (5000, 1_000_000) if not self.rehearse else (5000, 20000):
            # a filled state: slots at positions below and above the chunk's
            rng = np.random.default_rng(vocab)
            filled = rng.integers(0, 3 * CHUNK_ROWS, (N_COLS, vocab)).astype(np.int32)
            filled[rng.random((N_COLS, vocab)) < 0.5] = NEVER
            filled = torch.from_numpy(filled).to(dev)
            fresh = torch.full((N_COLS, vocab), NEVER, dtype=torch.int32, device=dev)
            hot = base.copy()
            hot[rng.random(hot.shape) < 0.25] = 12345  # one hash in a quarter of the rows
            cases = []
            for name, sp, n_valid in (("zipf_binary", base, CHUNK_ROWS),
                                      ("zipf_utf8", base, UTF8_LIVE),
                                      ("hot_quarter", hot, CHUNK_ROWS),
                                      ("all_invalid", base, 0),
                                      ("ragged_1001_rows", base[:1001], 1001),
                                      ("ragged_37_rows_some_invalid", base[:37], -1)):
                sp = sp.copy()
                if n_valid >= 0:
                    v = np.arange(sp.shape[0]) < n_valid
                else:
                    v = rng.random(sp.shape[0]) < 0.6
                sp[~v] = 0
                cases.append((name, torch.from_numpy(sp).to(dev), torch.from_numpy(v).to(dev)))
            for name, sp, v in cases:
                for state_name, fp in (("fresh", fresh), ("filled", filled)):
                    # (on the CPU the wrapper's host-side ceiling guard raises)
                    for rows_seen in (CHUNK_ROWS,) + (() if self.rehearse else (NEVER - 3,)):
                        ok = self.genvocab_case(fvops, fvref, vocab_lib, sp, v, fp, rows_seen)
                        records.append({"kernel": "fused_genvocab", "V": vocab, "chunk": name,
                                        "state": state_name, "rows_seen": rows_seen, "ok": ok})
        return records

    def time_genvocab(self, fvops, vops, vocab_lib, vocab, live) -> dict:
        torch, np, dev = self.torch, self.np, self.dev
        sparse_np = self.chunk(11)
        valid_np = np.arange(CHUNK_ROWS) < live
        sparse_np[~valid_np] = 0
        sparse = torch.from_numpy(sparse_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        warm = vocab_lib.VocabState.init(N_COLS, vocab, device=dev)
        for seed in (12, 13):
            prev = torch.from_numpy(self.chunk(seed)).to(dev)
            warm = fvops.fused_update(warm, prev, torch.ones(CHUNK_ROWS, dtype=torch.bool,
                                                             device=dev))
        reps = 20
        fresh = [vocab_lib.VocabState.init(N_COLS, vocab, device=dev) for _ in range(reps)]
        for s in fresh:
            s.rows_seen.copy_(warm.rows_seen)
        modded = (sparse.to(torch.int64) & 0xFFFFFFFF).remainder(vocab).to(torch.int32)
        pos = vocab_lib.positions(warm.rows_seen, CHUNK_ROWS, valid)
        p = None if self.rehearse else __import__("ctypes").c_void_p

        def item8():
            if self.rehearse:
                return vops.genvocab_update(warm, modded, valid)
            vops.KERNEL_GENVOCAB.launch(dev, p(warm.first_pos.data_ptr()), None,
                                        p(modded.data_ptr()), p(pos.data_ptr()), CHUNK_ROWS,
                                        N_COLS, vocab)

        def warm_call():
            return fvops.fused_update(warm, sparse, valid)

        touched = int(torch.unique(
            (torch.arange(N_COLS, device=dev)[None, :] * vocab + modded.long())[valid]).numel())
        n_bytes = live * N_COLS * 4 + CHUNK_ROWS + 8 + touched * 8
        rec = {"shape": f"[{CHUNK_ROWS}, {N_COLS}], {live} live rows, into [{N_COLS}, {vocab}]",
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "warm_event_ms": self.event_ms(warm_call, reps),
               "host_us_per_call": self.host_us(warm_call)}
        warm_dev = self.device_ms([warm_call] * reps)
        fresh_dev = self.device_ms([lambda s=s: fvops.fused_update(s, sparse, valid)
                                    for s in fresh])
        item8_dev = self.device_ms([item8] * reps)
        if not self.rehearse:
            rec.update(warm_ms=warm_dev["total"], fresh_ms=fresh_dev["total"],
                       item8_genvocab_ms=item8_dev["total"])
        return rec

    def launch_floor(self, _build) -> dict | None:
        """The device time of an empty kernel, where the tree's
        fused_vocab.cu exports one; None otherwise."""
        if self.rehearse:
            return None
        lib = _build.library("fused_vocab")
        if not hasattr(lib, "empty_kernel"):
            return None
        import ctypes

        fn = lib.empty_kernel
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        torch = self.torch

        def call():
            err = fn(torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"empty_kernel: CUDA error {err}")

        return {"device_ms": self.device_ms([call] * 50)["total"],
                "event_ms": self.event_ms(call, 50)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--time-only", action="store_true",
                    help="skip the checks (for timing a variant tree that computes wrong sums)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import vocab as vocab_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as ebops, ref as ebref
    from repro_torch.kernels.fused_vocab import ops as fvops, ref as fvref
    from repro_torch.kernels.vocab import ops as vops

    dev = torch.device("cpu" if args.rehearse else "cuda")
    bench = Bench(torch, np, dev, args.rehearse)
    records = {"label": args.label, "src": args.src}
    if not args.rehearse:
        torch.backends.cuda.matmul.allow_tf32 = False
        records["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        t0 = time.perf_counter()
        paths = _build.build(("embedding_bag", "fused_vocab", "vocab"))
        records["build"] = {"seconds": time.perf_counter() - t0, "ptxas": {
            name: ptxas_entries(Path(f"{path}.log").read_text()) for name, path in paths.items()}}
        emit({"build": records["build"]})

    failed = []
    records["checks"] = []
    for shape in [] if args.time_only else REHEARSAL_GRAD_CHECKS if args.rehearse else GRAD_CHECKS:
        rec = bench.check_grad(ebops, ebref, shape)
        emit({"check": rec})
        records["checks"].append(rec)
        if not rec["ok"]:
            failed.append(rec)
    for rec in [] if args.time_only else bench.check_genvocab(fvops, fvref, vocab_lib):
        records["checks"].append(rec)
        if not rec["ok"]:
            failed.append(rec)
            emit({"check": rec})
    emit({"checks_passed": len(records["checks"]) - len(failed), "checks": len(records["checks"])})
    if failed:
        emit({"failed": failed})
        return 1

    records["times"] = {}
    for tag, vocab in (REHEARSAL_RANGES if args.rehearse else RANGES).items():
        rec = bench.time_grad(ebops, ebref, tag, vocab)
        records["times"][f"embedding_gather_backward@{tag}"] = rec
        emit({"time": {f"embedding_gather_backward@{tag}": rec}})
        for feed, live in (("utf8", UTF8_LIVE), ("binary", CHUNK_ROWS)):
            rec = bench.time_genvocab(fvops, vops, vocab_lib, vocab, live)
            records["times"][f"fused_genvocab@{tag}/{feed}"] = rec
            emit({"time": {f"fused_genvocab@{tag}/{feed}": rec}})
    records["launch_floor"] = bench.launch_floor(_build)
    emit({"launch_floor": records["launch_floor"]})

    records["failed"] = failed
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))
    emit(records)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
