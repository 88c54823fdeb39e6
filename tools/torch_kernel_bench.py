#!/usr/bin/env python3
"""The embedding gradient, loop ①'s GenVocab kernels, the per-op
ApplyVocab and the dense transform alone on one NVIDIA GPU.

    python3 tools/torch_kernel_bench.py [--src SRC] [--out results.json] [--label NAME]
        [--only genvocab,fused_genvocab,fused_genvocab_counts,embedding_gather_backward,
                apply_vocab,dense_transform]
    python3 tools/torch_kernel_bench.py --rehearse     # plumbing only, on the CPU

``--src`` is a ``src/`` directory that holds a ``repro_torch`` package
(default: this checkout's); run the script once per tree, in one command,
to compare two trees on one card (old, new, new, old). It prints, one JSON
object a line:

1. ``build``: the seconds to build ``csrc/embedding_bag.cu``,
   ``csrc/fused_vocab.cu``, ``csrc/vocab.cu`` and ``csrc/dense_xform.cu``,
   and for each kernel the registers and spill bytes ``ptxas -v``
   reported;
2. ``check``: each kernel against its plain version, as the card tests
   hold it. ``embedding_gather_backward`` within (n-1)·2^-24·Σ|terms| of
   the float64 plain gradient and bit-identical across two launches, at
   the train path's shapes and at batches 4095, 4097, 8192 (V 10^6) and
   16384, one id in every row of a column, and dropped ids;
   ``fused_genvocab`` bit for bit on ``first_pos`` and ``rows_seen``: a
   fresh and a filled state, a Zipf chunk where one hash fills a quarter
   of the rows, an all-invalid chunk, a row count that is no multiple of
   32, and ``rows_seen`` at NEVER - 3; ``fused_genvocab_counts`` on the
   same cases with the count plane (``counts`` bit for bit too, from 0 on
   the fresh state and from 0-8 on the filled one); the per-op
   ``genvocab_update``
   bit for bit against ``vocab.update`` (``first_pos``, ``counts``,
   ``rows_seen``) on the crossed plan's 27 modded columns: the utf8
   chunk's valid prefix, a valid mask that is no prefix, no valid row, 40
   columns, ``rows_seen`` at 0 and NEVER - 3, with and without counts;
   ``apply_vocab`` bit for bit against ``torch.gather`` at [16384, 27],
   [4099, 27], [1027, 1] and [517, 64], V 1, 97, 5000 and 10^6 (and 2^31 - 1
   at one column: an 8 GiB table), from a 16-byte aligned address and from
   one 4 bytes past it; ``dense_transform`` within rtol 1e-6 of its plain
   version (NaN equal), int32 and f32, at [16384, 12], [1, 1], [3, 5],
   [4099, 13] and [2^22, 13], from a 16-byte aligned address and from one
   4 bytes past it;
3. ``time``: at the main path's shapes, each kernel's device time per
   call from torch.profiler (kernels and memsets by name, so the
   gradient's stages show apart) and its CUDA-event time per call, back
   to back after a warm-up. The gradient: grad_out f32 [4096, 26, 64],
   Piper-like ordinals [4096, 26] (a Zipf(1.3) feed's first sightings)
   into [26, V, 64], with ``torch.zeros().index_add_`` beside it.
   ``fused_genvocab``: sparse [16384, 26] with 3745 live rows (a 1 MiB
   utf8 chunk) or 16384 (a binary chunk), into a state filled by two
   earlier chunks ("warm") or all NEVER ("fresh", a new state for each
   call), the host µs to issue one wrapper call, and an empty kernel's
   device time (the launch floor, where the tree has one);
   ``fused_genvocab_counts`` alike with the count plane (its bound counts
   both planes). The per-op
   ``genvocab_update``, the whole call, on the same chunk's hashes modded
   with a 27th column crossed from the first two (the crossed plan's
   shape): device ms per call, the device kernels per call by name
   (``chip_smoke.device_kernels``), event ms, host µs per call, and
   ``scatter_reduce_(amin)`` on the transposed indices and positions made
   beforehand beside it; where the tree's ``genvocab`` kernel still takes
   positions (an older tree), the kernel alone too. ``apply_vocab`` on the
   crossed plan's [16384, 27] modded chunk through a random table, with
   ``torch.gather`` on the transposed int64 indices beside it, and its
   bound by touched slots and by touched 32-byte sectors. V = 5000 and
   10^6. ``dense_transform`` on the crossed plan's [16384, 12] int32 dense
   group and on the same values as f32, with its plain version beside it
   (no one PyTorch call computes it) and one ``torch.clamp`` of the f32
   values (one PyTorch elementwise pass over the same bytes). Each timed
   record holds its byte and operation bounds (``bound_ms_bytes``,
   ``bound_ms_operations``; ``bound_ms`` is the larger). The launch floor
   has PyTorch's 1-element ``fill_`` beside it. Device ms by kernel name
   add up the kernels whose names agree in their first 60 characters.

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
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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


def bounds(n_bytes: int, n_ops: int) -> dict:
    """The least time (ms) the card could take, by bytes over the memory rate
    and by operations over the float32 rate; ``bound_ms`` is the larger."""
    b, o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_ms_bytes": b, "bound_ms_operations": o}


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
            by_name = {}  # names cut to 60 characters; kernels whose names agree that far add up
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
                    v = by_name.setdefault(e.key[:60], {"count": 0, "ms": 0.0})
                    v["count"] += e.count
                    v["ms"] += e.self_device_time_total / 1e3 / n
            if by_name:
                break
        return {"by_name": by_name, "total": sum(v["ms"] for v in by_name.values())}

    def kernels_per_call(self, fn, calls: int = 5) -> dict | None:
        """Device kernels and copies of one call of ``fn`` by name
        (``chip_smoke.device_kernels`` over ``calls`` calls, over
        ``calls``); None in a rehearsal."""
        if self.rehearse:
            return None
        from chip_smoke import device_kernels

        found = {}  # names cut to 60 characters; kernels whose names agree that far add up
        for name, n in device_kernels(self.torch, fn, calls).items():
            found[name[:60]] = found.get(name[:60], 0) + n / calls
        return found

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
    def genvocab_case(self, fvops, fvref, vocab_lib, sparse, valid, first_pos, rows_seen,
                      counts=None):
        torch = self.torch

        def state():
            return vocab_lib.VocabState(first_pos.clone(),
                                        torch.tensor(rows_seen, dtype=torch.int32, device=self.dev),
                                        None if counts is None else counts.clone())

        got = fvops.fused_update(state(), sparse, valid)
        want = state()
        seen = fvref.fused_genvocab(want.first_pos, want.counts, sparse, valid, want.rows_seen)
        self.sync()
        return bool(torch.equal(got.first_pos, want.first_pos)) and bool(
            torch.equal(got.rows_seen, seen)) and (
            counts is None or bool(torch.equal(got.counts, want.counts)))

    def check_genvocab(self, fvops, fvref, vocab_lib, track: bool = False) -> list:
        """fused_genvocab (or, with ``track``, fused_genvocab_counts) bit for
        bit against its plain version."""
        torch, np, dev = self.torch, self.np, self.dev
        kernel = "fused_genvocab_counts" if track else "fused_genvocab"
        records = []
        base = self.chunk(11)
        for vocab in (5000, 1_000_000) if not self.rehearse else (5000, 20000):
            # a filled state: slots at positions below and above the chunk's
            rng = np.random.default_rng(vocab)
            filled = rng.integers(0, 3 * CHUNK_ROWS, (N_COLS, vocab)).astype(np.int32)
            filled[rng.random((N_COLS, vocab)) < 0.5] = NEVER
            filled = torch.from_numpy(filled).to(dev)
            fresh = torch.full((N_COLS, vocab), NEVER, dtype=torch.int32, device=dev)
            counts = {"fresh": torch.zeros_like(fresh), "filled": torch.from_numpy(
                rng.integers(0, 9, (N_COLS, vocab)).astype(np.int32)).to(dev)}
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
                        ok = self.genvocab_case(fvops, fvref, vocab_lib, sp, v, fp, rows_seen,
                                                counts[state_name] if track else None)
                        records.append({"kernel": kernel, "V": vocab, "chunk": name,
                                        "state": state_name, "rows_seen": rows_seen, "ok": ok})
        return records

    def time_genvocab(self, fvops, vocab_lib, vocab, live, track: bool = False) -> dict:
        torch, np, dev = self.torch, self.np, self.dev
        sparse_np = self.chunk(11)
        valid_np = np.arange(CHUNK_ROWS) < live
        sparse_np[~valid_np] = 0
        sparse = torch.from_numpy(sparse_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        warm = vocab_lib.VocabState.init(N_COLS, vocab, track_counts=track, device=dev)
        for seed in (12, 13):
            prev = torch.from_numpy(self.chunk(seed)).to(dev)
            warm = fvops.fused_update(warm, prev, torch.ones(CHUNK_ROWS, dtype=torch.bool,
                                                             device=dev))
        reps = 20
        fresh = [vocab_lib.VocabState.init(N_COLS, vocab, track_counts=track, device=dev)
                 for _ in range(reps)]
        for s in fresh:
            s.rows_seen.copy_(warm.rows_seen)
        modded = (sparse.to(torch.int64) & 0xFFFFFFFF).remainder(vocab).to(torch.int32)
        def warm_call():
            return fvops.fused_update(warm, sparse, valid)

        touched = int(torch.unique(
            (torch.arange(N_COLS, device=dev)[None, :] * vocab + modded.long())[valid]).numel())
        # valid flags in, the live rows' hashes in, rows_seen in and out, each
        # touched slot of each plane read and written once; the modulus, the
        # compare and the min of each live cell
        planes = 2 if track else 1
        rec = {"shape": f"[{CHUNK_ROWS}, {N_COLS}], {live} live rows, into [{N_COLS}, {vocab}]"
                        + (" with counts" if track else ""),
               **bounds(live * N_COLS * 4 + CHUNK_ROWS + 8 + touched * 8 * planes,
                        4 * live * N_COLS),
               "warm_event_ms": self.event_ms(warm_call, reps),
               "host_us_per_call": self.host_us(warm_call)}
        warm_dev = self.device_ms([warm_call] * reps)
        fresh_dev = self.device_ms([lambda s=s: fvops.fused_update(s, sparse, valid)
                                    for s in fresh])
        if not self.rehearse:
            rec.update(warm_ms=warm_dev["total"], fresh_ms=fresh_dev["total"],
                       stages=warm_dev["by_name"], kernels_per_call=self.kernels_per_call(warm_call))
        return rec

    # -- the per-op genvocab -------------------------------------------- #
    def crossed_modded(self, sparse, vocab):
        """The crossed plan's 27 modded columns of a [rows, 26] hash chunk:
        the 26, then the cross of columns 0 and 1."""
        from repro_torch.core import ops

        torch = self.torch
        crossed = torch.cat([sparse, ops.hash_cross(sparse[:, 0], sparse[:, 1])[:, None]], dim=1)
        return ops.positive_modulus(crossed, vocab)

    def check_per_op_genvocab(self, vops, vocab_lib) -> list:
        torch, np, dev = self.torch, self.np, self.dev
        records = []
        sparse = torch.from_numpy(self.chunk(11)).to(dev)
        rng = np.random.default_rng(8)
        for vocab in (97, 5000, 1_000_000) if not self.rehearse else (97, 5000, 20000):
            modded = self.crossed_modded(sparse, vocab)
            modded40 = torch.cat([modded, modded[:, :13].flip(0)], dim=1).contiguous()
            history = rng.integers(0, 3 * CHUNK_ROWS, (40, vocab)).astype(np.int32)
            history[rng.random(history.shape) < 0.5] = NEVER
            history = torch.from_numpy(history).to(dev)
            counts = torch.from_numpy(rng.integers(0, 9, (40, vocab)).astype(np.int32)).to(dev)
            prefix = torch.arange(CHUNK_ROWS, device=dev) < UTF8_LIVE
            scattered = torch.from_numpy(rng.random(CHUNK_ROWS) < 0.4).to(dev)
            for name, m, v in (("utf8_prefix", modded, prefix), ("scattered", modded, scattered),
                               ("no_valid_row", modded, torch.zeros_like(prefix)),
                               ("40_columns", modded40, scattered)):
                n_cols = m.shape[1]
                for track in (False, True):
                    for rows_seen in (0,) + (() if self.rehearse else (NEVER - 3,)):
                        def state():
                            return vocab_lib.VocabState(
                                history[:n_cols].clone(),
                                torch.tensor(rows_seen, dtype=torch.int32, device=dev),
                                counts[:n_cols].clone() if track else None)

                        got = vops.genvocab_update(state(), m, v)
                        want = vocab_lib.update(state(), m, v)
                        self.sync()
                        ok = all(torch.equal(getattr(got, f), getattr(want, f))
                                 for f in ("first_pos", "rows_seen")
                                 ) and (not track or torch.equal(got.counts, want.counts))
                        records.append({"kernel": "genvocab", "V": vocab, "chunk": name,
                                        "counts": track, "rows_seen": rows_seen, "ok": bool(ok)})
        return records

    def time_per_op_genvocab(self, vops, vocab_lib, vocab, live) -> dict:
        """genvocab_update, the whole call, on the crossed plan's [16384, 27]
        modded chunk with ``live`` valid rows, into a state filled by two
        earlier chunks."""
        torch, np, dev = self.torch, self.np, self.dev
        valid = torch.arange(CHUNK_ROWS, device=dev) < live
        modded = self.crossed_modded(torch.from_numpy(self.chunk(11)).to(dev), vocab)
        n_cols = modded.shape[1]
        warm = vocab_lib.VocabState.init(n_cols, vocab, device=dev)
        for seed in (12, 13):
            prev = self.crossed_modded(torch.from_numpy(self.chunk(seed)).to(dev), vocab)
            warm = vops.genvocab_update(warm, prev, torch.ones(CHUNK_ROWS, dtype=torch.bool,
                                                               device=dev))
        pos = vocab_lib.positions(warm.rows_seen, CHUNK_ROWS, valid)
        idx_t = modded.t().to(torch.int64).contiguous()
        src = pos[None, :].expand_as(idx_t).contiguous()
        touched = int(torch.unique((torch.arange(n_cols, device=dev)[None, :] * vocab
                                    + modded.long())[valid]).numel())
        n_bytes = live * n_cols * 4 + CHUNK_ROWS + 8 + touched * 8
        reps = 20

        def call():
            return vops.genvocab_update(warm, modded, valid)

        def library():
            return warm.first_pos.scatter_reduce_(1, idx_t, src, reduce="amin")

        rec = {"shape": f"modded [{CHUNK_ROWS}, {n_cols}], {live} live rows, "
                        f"into [{n_cols}, {vocab}]",
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "event_ms": self.event_ms(call, reps), "host_us_per_call": self.host_us(call),
               "library_event_ms": self.event_ms(library, reps)}
        whole = self.device_ms([call] * reps)
        lib = self.device_ms([library] * reps)
        alone = None
        if len(vops.KERNEL_GENVOCAB.argtypes) == 7 and not self.rehearse:
            import ctypes

            p = ctypes.c_void_p

            def kernel_alone():  # an older tree's kernel, on positions made above
                vops.KERNEL_GENVOCAB.launch(dev, p(warm.first_pos.data_ptr()), None,
                                            p(modded.data_ptr()), p(pos.data_ptr()),
                                            CHUNK_ROWS, n_cols, vocab)

            alone = self.device_ms([kernel_alone] * reps)
        if not self.rehearse:
            rec.update(device_ms=whole["total"], stages=whole["by_name"],
                       kernels_per_call=self.kernels_per_call(call),
                       library_device_ms=lib["total"],
                       kernel_alone_ms=None if alone is None else alone["total"])
        return rec

    # -- apply_vocab ---------------------------------------------------- #
    def check_apply_vocab(self, vops) -> list:
        torch, np, dev = self.torch, self.np, self.dev
        records = []
        ranges = (1, 97, 5000, 20000) if self.rehearse else (1, 97, 5000, 1_000_000, 2**31 - 1)
        for vocab in ranges:
            shapes = ((257, 1),) if vocab == 2**31 - 1 else (
                (CHUNK_ROWS, 27), (4099, 27), (1027, 1), (517, 64))
            for rows, n_cols in shapes:
                for offset in (0, 1):
                    rng = np.random.default_rng(rows + n_cols + vocab % 1000)
                    table = torch.randint(0, 2**31 - 1, (n_cols, vocab), dtype=torch.int32,
                                          device=dev)
                    values = rng.integers(0, vocab, rows * n_cols + offset).astype(np.int32)
                    modded = torch.from_numpy(values).to(dev)[offset:].view(rows, n_cols)
                    got = vops.apply_vocab(table, modded)
                    want = torch.gather(table, 1, modded.t().to(torch.int64)).t()
                    self.sync()
                    records.append({"kernel": "apply_vocab", "V": vocab, "rows": rows,
                                    "n_cols": n_cols, "offset": offset,
                                    "ok": bool(torch.equal(got, want))})
                    del table
        return records

    def time_apply_vocab(self, vops, vocab) -> dict:
        """apply_vocab on the crossed plan's [16384, 27] modded chunk
        through a random [27, vocab] table, torch.gather beside it."""
        torch, dev = self.torch, self.dev
        modded = self.crossed_modded(torch.from_numpy(self.chunk(11)).to(dev), vocab)
        n_cols = modded.shape[1]
        table = torch.randint(0, 2**31 - 1, (n_cols, vocab), dtype=torch.int32, device=dev)
        idx_t = modded.t().to(torch.int64).contiguous()
        slots = torch.arange(n_cols, device=dev)[None, :] * vocab + modded.long()
        touched = int(torch.unique(slots).numel())
        sectors = int(torch.unique(slots // 8).numel())
        io = CHUNK_ROWS * n_cols * 8  # the modded values in, the ids out
        reps = 20

        def call():
            return vops.apply_vocab(table, modded)

        def library():
            return torch.gather(table, 1, idx_t)

        rec = {"shape": f"modded [{CHUNK_ROWS}, {n_cols}], table [{n_cols}, {vocab}]",
               "touched_slots": touched, "touched_sectors": sectors,
               "bound_ms": (io + touched * 4) / HBM_BYTES_PER_S * 1e3,
               "bound_ms_by_sectors": (io + sectors * 32) / HBM_BYTES_PER_S * 1e3,
               "event_ms": self.event_ms(call, reps), "host_us_per_call": self.host_us(call),
               "library_event_ms": self.event_ms(library, reps)}
        if not self.rehearse:
            dev_ms = self.device_ms([call] * reps)
            lib = self.device_ms([library] * reps)
            rec.update(device_ms=dev_ms["total"], stages=dev_ms["by_name"],
                       kernels_per_call=self.kernels_per_call(call),
                       library_device_ms=lib["total"])
        return rec

    # -- dense_transform ------------------------------------------------ #
    def dense_input(self, n: int, dtype: str, seed: int):
        """n int32 values (extremes first) or n f32 values (NaN, ±inf and
        -0.0 first), made on the device from a seed."""
        torch = self.torch
        gen = torch.Generator(self.dev).manual_seed(seed)
        if dtype == "int32":
            x = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=self.dev,
                              generator=gen)
            head = torch.tensor([-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1], dtype=torch.int32)
        else:
            x = torch.randn(n, device=self.dev, generator=gen) * 1e3
            head = torch.tensor([float("nan"), -float("inf"), -0.0, 1e-30, float("inf")])
        k = min(n, len(head))
        x[:k] = head[:k].to(self.dev)
        return x

    def check_dense(self, dxops, dxref) -> list:
        torch = self.torch
        records = []
        shapes = [(CHUNK_ROWS, 12), (1, 1), (3, 5), (4099, 13)] + (
            [] if self.rehearse else [(1 << 22, 13)])
        for rows, cols in shapes:
            for dtype in ("int32", "float32"):
                for offset in (0, 1):
                    n = rows * cols
                    x = self.dense_input(n + offset, dtype, rows)[offset:].view(rows, cols)
                    got, want = dxops.dense_transform(x), dxref.dense_transform(x)
                    self.sync()
                    ok = bool(torch.allclose(got, want, rtol=1e-6, atol=0, equal_nan=True))
                    records.append({"kernel": "dense_transform", "shape": [rows, cols],
                                    "dtype": dtype, "offset": offset, "ok": ok})
        return records

    def time_dense(self, dxops, dxref, dtype: str) -> dict:
        """dense_transform on the crossed plan's [16384, 12] dense group
        (int32, or the same values as f32), its plain version beside it."""
        x = self.dense_input(CHUNK_ROWS * 12, "int32", 12).view(CHUNK_ROWS, 12)
        if dtype == "float32":
            x = x.to(self.torch.float32)
        n, reps = x.numel(), 20

        def call():
            return dxops.dense_transform(x)

        def plain():
            return dxref.dense_transform(x)

        rec = {"shape": f"{dtype} [{CHUNK_ROWS}, 12]", **bounds(n * 8, 20 * n),
               "event_ms": self.event_ms(call, reps), "host_us_per_call": self.host_us(call),
               "plain_event_ms": self.event_ms(plain, reps)}
        if not self.rehearse:
            dev_ms = self.device_ms([call] * reps)
            plain_ms = self.device_ms([plain] * reps)
            # one PyTorch elementwise pass over the same bytes (not the same
            # function): clamp of the f32 values
            xf = x.to(self.torch.float32)
            clamp = self.device_ms([lambda: self.torch.clamp(xf, min=0.0)] * reps)
            rec.update(device_ms=dev_ms["total"], stages=dev_ms["by_name"],
                       torch_clamp_device_ms=clamp["total"],
                       kernels_per_call=self.kernels_per_call(call),
                       plain_device_ms=plain_ms["total"], plain_stages=plain_ms["by_name"])
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

        one = torch.zeros(1, device=self.dev)
        return {"device_ms": self.device_ms([call] * 50)["total"],
                "event_ms": self.event_ms(call, 50),
                # PyTorch's own smallest kernel beside it: a 1-element fill_
                "torch_fill_device_ms": self.device_ms([lambda: one.fill_(1.0)] * 50)["total"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--time-only", action="store_true",
                    help="skip the checks (for timing a variant tree that computes wrong sums)")
    ap.add_argument("--only", default=None,
                    help="check and time only these kernels (comma-separated): "
                         "embedding_gather_backward, fused_genvocab, fused_genvocab_counts, "
                         "genvocab, apply_vocab, dense_transform")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))  # chip_smoke's kernel count per call
    from repro_torch.core import vocab as vocab_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels.dense_xform import ops as dxops, ref as dxref
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
        paths = _build.build(("embedding_bag", "fused_vocab", "vocab", "dense_xform"))
        records["build"] = {"seconds": time.perf_counter() - t0, "ptxas": {
            name: ptxas_entries(Path(f"{path}.log").read_text()) for name, path in paths.items()}}
        emit({"build": records["build"]})

    only = set(args.only.split(",")) if args.only else {
        "embedding_gather_backward", "fused_genvocab", "fused_genvocab_counts", "genvocab",
        "apply_vocab", "dense_transform"}
    failed = []
    records["checks"] = []
    grad_checks = REHEARSAL_GRAD_CHECKS if args.rehearse else GRAD_CHECKS
    for shape in grad_checks if "embedding_gather_backward" in only and not args.time_only else []:
        rec = bench.check_grad(ebops, ebref, shape)
        emit({"check": rec})
        records["checks"].append(rec)
        if not rec["ok"]:
            failed.append(rec)
    genvocab_checks = []
    if not args.time_only:
        if "fused_genvocab" in only:
            genvocab_checks += bench.check_genvocab(fvops, fvref, vocab_lib)
        if "fused_genvocab_counts" in only:
            genvocab_checks += bench.check_genvocab(fvops, fvref, vocab_lib, track=True)
        if "genvocab" in only:
            genvocab_checks += bench.check_per_op_genvocab(vops, vocab_lib)
        if "apply_vocab" in only:
            genvocab_checks += bench.check_apply_vocab(vops)
        if "dense_transform" in only:
            genvocab_checks += bench.check_dense(dxops, dxref)
    for rec in genvocab_checks:
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
        timed = []
        if "embedding_gather_backward" in only:
            timed.append((f"embedding_gather_backward@{tag}",
                          lambda: bench.time_grad(ebops, ebref, tag, vocab)))
        for feed, live in (("utf8", UTF8_LIVE), ("binary", CHUNK_ROWS)):
            if "fused_genvocab" in only:
                timed.append((f"fused_genvocab@{tag}/{feed}", lambda live=live:
                              bench.time_genvocab(fvops, vocab_lib, vocab, live)))
            if "fused_genvocab_counts" in only:
                timed.append((f"fused_genvocab_counts@{tag}/{feed}", lambda live=live:
                              bench.time_genvocab(fvops, vocab_lib, vocab, live, track=True)))
            if "genvocab" in only:
                timed.append((f"genvocab@{tag}/{feed}", lambda live=live:
                              bench.time_per_op_genvocab(vops, vocab_lib, vocab, live)))
        if "apply_vocab" in only:
            timed.append((f"apply_vocab@{tag}", lambda: bench.time_apply_vocab(vops, vocab)))
        if "dense_transform" in only and tag == "5K":  # the transform has no vocab range
            for dtype in ("int32", "float32"):
                timed.append((f"dense_transform/{dtype}",
                              lambda dtype=dtype: bench.time_dense(dxops, dxref, dtype)))
        for name, fn in timed:
            records["times"][name] = fn()
            emit({"time": {name: records["times"][name]}})
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
