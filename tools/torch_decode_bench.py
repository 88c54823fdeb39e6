#!/usr/bin/env python3
"""decode_scan and loop ②'s fused transform alone on one NVIDIA GPU.

    python3 tools/torch_decode_bench.py [--src SRC] [--out results.json] [--label NAME]
    python3 tools/torch_decode_bench.py --rehearse     # plumbing only, on the CPU

``--src`` is a ``src/`` directory that holds a ``repro_torch`` package
(default: this checkout's); run the script once per tree, in one command,
to compare two trees on one card (old, new, new, old). It prints, one JSON
object a line:

1. ``build``: the seconds to build ``csrc/decode_utf8.cu``,
   ``csrc/fused_xform.cu``, the two bytes-in kernels and
   ``csrc/fused_vocab.cu`` (for its empty kernel), and for each kernel the
   registers and spill bytes ``ptxas -v`` reported;
2. ``check``: each kernel against its plain version, as the card tests
   hold it, run twice for the same bits. ``decode`` bit for bit on the
   utf8 feed's first 1, 2 and 4 MiB chunks at max_rows 16384, the smoke's
   hostile chunks, a field longer than two tiles, data that ends on a tile
   boundary and one byte past it, n of 0 and 1 and 4097, more delimiters
   than cells, rows one field too long or short, a truncated row, an
   all-padding chunk, rows three fields long or two short over four tiles
   and max_rows inside a tile; ``fused_decode_transform`` and
   ``fused_decode_genvocab`` (``first_pos`` and ``rows_seen``, into a state
   with history, at ``rows_seen`` 0 and NEVER - 3) on the same chunks and
   the 1 MiB chunk at max_rows 1000; ``fused_transform`` ids bit for bit and dense
   within rtol 1e-6 at V 1, 2, 97, 4096, 5000, 10^6 and 2^31 - 1 (one
   column there: its table is 8 GiB), with hashes at int32 min and max
   and -1, a row count that is no multiple of 4, and no dense columns;
3. ``time``: at the main path's shapes, each kernel's device time per
   call from one short torch.profiler pass (by kernel name, so decode's
   stages show apart), its device kernels per call by name
   (``chip_smoke.device_kernels``) and its CUDA-event time per call, back
   to back after a warm-up. ``decode_scan``: the utf8 feed's
   first 1 MiB chunk (seed 0, 2^18 rows) at max_rows 16384, its first 2
   and 4 MiB chunks at the same max_rows, and the hostile chunks.
   ``fused_transform`` and ``fused_mod_dense``: sparse [16384, 26] and
   dense [16384, 13] decoded from that chunk, through a vocabulary
   finalized from chunks 1 and 2 at V = 5000 and 10^6, with
   ``torch.gather`` on the modded indices beside it. The bytes-in kernels
   ``fused_decode_genvocab`` and ``fused_decode_transform`` on the same
   chunk, the 2 and 4 MiB chunks and the first two hostile chunks too. And
   an empty kernel's device time (the launch floor).

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

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_kernel_bench import Bench, emit, ptxas_entries  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32  # bytes the card reads from device memory at a time
RANGES = {"5K": 5000, "1M": 1_000_000}
REHEARSAL_RANGES = {"5K": 5000, "1M": 20000}
MAX_ROWS, CHUNK_BYTES, N_DENSE, N_SPARSE = 1 << 14, 1 << 20, 13, 26
NEVER = 0x7FFFFFFF
N_FIELDS = 1 + N_DENSE + N_SPARSE
SOURCES = ("decode_utf8", "fused_xform", "fused_decode_vocab", "fused_decode_xform",
           "fused_vocab")
XFORM_RANGES = (1, 2, 97, 4096, 5000, 1_000_000, 2**31 - 1)
LARGER_CHUNKS = (2 << 20, 4 << 20)  # decode's other timed chunk sizes, bytes


class DecodeBench(Bench):
    only = None  # names of the kernels to time; None: all

    def data(self):
        """The utf8 feed's first three 1 MiB chunks (the smoke's feed), and
        its first chunk at the other sizes decode is timed at."""
        from repro_torch.data import synth

        rows = 4000 if self.rehearse else 1 << 18
        buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows, seed=0))
        chunk = (1 << 16) if self.rehearse else CHUNK_BYTES
        chunks = [c for _, c in zip(range(3), synth.chunk_stream(buf, chunk))]
        self.sized = [(f"{size >> 20}MiB", next(iter(synth.chunk_stream(buf, size))), MAX_ROWS)
                      for size in LARGER_CHUNKS]
        return chunks

    def hostile(self) -> list:
        """(name, uint8 array, max_rows) of the smoke's hostile chunks."""
        np = self.np
        import chip_smoke

        cases = []
        for seed, (n_rows, max_rows, truncate) in enumerate(
                [(3000, 2048, 7), (3000, 4096, 0), (400, 512, 1), (64, 32, 40)]):
            raw = chip_smoke.hostile_rows(np, seed, N_DENSE, N_SPARSE, n_rows, truncate)
            buf = np.zeros(len(raw) + 4096, np.uint8)
            buf[: len(raw)] = np.frombuffer(raw, np.uint8)
            cases.append((f"hostile_{seed}", buf, max_rows))
        return cases

    # -- decode --------------------------------------------------------- #
    def check_decode(self, dops, dref, chunks) -> list:
        np, torch = self.np, self.torch
        import chip_smoke

        hex_t = np.arange(N_FIELDS) > N_DENSE
        cases = [("synth_1MiB", chunks[0], MAX_ROWS)] + self.sized + self.hostile()
        cases += chip_smoke.decode_edge_chunks(np)
        records = []
        for name, arr, max_rows in cases:
            b = torch.from_numpy(arr).to(self.dev)
            kw = dict(n_fields=N_FIELDS, max_rows=max_rows, n_dense=N_DENSE, n_sparse=N_SPARSE)
            got = dops.decode(b, hex_t, **kw)
            again = dops.decode(b, hex_t, **kw)
            want = dref.decode_bytes(b, hex_t, **kw)
            self.sync()
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            records.append({"kernel": "decode_scan", "chunk": name, "bytes": int(arr.size),
                            "max_rows": max_rows, "deterministic": same, "exact": exact,
                            "ok": same and exact})
        return records

    # -- fused_decode_transform ----------------------------------------- #
    def check_decode_xform(self, fdxops, fdxref, vocab_lib, chunks) -> list:
        np, torch = self.np, self.torch
        import chip_smoke

        cases = [("synth_1MiB", chunks[0], MAX_ROWS), ("synth_1MiB_1000_rows", chunks[0], 1000)]
        cases += self.sized + self.hostile() + chip_smoke.decode_edge_chunks(np)
        gen = torch.Generator(self.dev).manual_seed(5)
        table = torch.randint(0, 2**31 - 1, (N_SPARSE, 5000), generator=gen, dtype=torch.int32,
                              device=self.dev)
        vocab = vocab_lib.Vocabulary(table=table, sizes=torch.zeros(N_SPARSE, dtype=torch.int32))
        fkw = dict(n_fields=N_FIELDS, hex_start=1 + N_DENSE)
        records = []
        for name, arr, max_rows in cases:
            b = torch.from_numpy(arr).to(self.dev)
            got = fdxops.fused_decode_transform(vocab, b, max_rows=max_rows, **fkw)
            again = fdxops.fused_decode_transform(vocab, b, max_rows=max_rows, **fkw)
            want = fdxref.fused_decode_transform(vocab, b, max_rows=max_rows, **fkw)
            self.sync()
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            exact = all(torch.equal(got[i], want[i]) for i in (0, 2, 3)) and bool(
                torch.allclose(got[1], want[1], rtol=1e-6, atol=0))
            records.append({"kernel": "fused_decode_transform", "chunk": name,
                            "bytes": int(arr.size), "max_rows": max_rows, "deterministic": same,
                            "exact": exact, "ok": same and exact})
        return records

    # -- fused_decode_genvocab ------------------------------------------ #
    def check_decode_genvocab(self, fdvops, fdvref, vocab_lib, chunks) -> list:
        np, torch = self.np, self.torch
        import chip_smoke

        cases = [("synth_1MiB", chunks[0], MAX_ROWS), ("synth_1MiB_1000_rows", chunks[0], 1000)]
        cases += self.sized + self.hostile() + chip_smoke.decode_edge_chunks(np)
        rng = np.random.default_rng(6)
        history = np.where(rng.random((N_SPARSE, 5000)) < 0.2,
                           rng.integers(0, 50, (N_SPARSE, 5000)), NEVER).astype(np.int32)
        history = torch.from_numpy(history).to(self.dev)
        fkw = dict(n_fields=N_FIELDS, hex_start=1 + N_DENSE)
        records = []
        for name, arr, max_rows in cases:
            b = torch.from_numpy(arr).to(self.dev)
            for rows_seen in (0,) + (() if self.rehearse else (NEVER - 3,)):
                def state():
                    return vocab_lib.VocabState(history.clone(), torch.tensor(
                        rows_seen, dtype=torch.int32, device=self.dev))

                got = fdvops.fused_decode_update(state(), b, max_rows=max_rows, **fkw)
                again = fdvops.fused_decode_update(state(), b, max_rows=max_rows, **fkw)
                want = fdvref.fused_decode_genvocab(state(), b, max_rows=max_rows, **fkw)
                self.sync()
                same = all(torch.equal(getattr(got, f), getattr(again, f))
                           for f in ("first_pos", "rows_seen"))
                exact = all(torch.equal(getattr(got, f), getattr(want, f))
                            for f in ("first_pos", "rows_seen"))
                records.append({"kernel": "fused_decode_genvocab", "chunk": name,
                                "bytes": int(arr.size), "max_rows": max_rows,
                                "rows_seen": rows_seen, "deterministic": same, "exact": exact,
                                "ok": same and exact})
        return records

    # -- fused_transform ------------------------------------------------ #
    def check_xform(self, fxops, fxref, vocab_lib) -> list:
        np, torch = self.np, self.torch
        records = []
        ranges = (1, 2, 97, 4096, 5000, 20000) if self.rehearse else XFORM_RANGES
        for vr in ranges:
            for rows, n_sparse, n_dense in ((4099, 26, 13), (37, 3, 0)):
                if vr >= 2**31 - 1:
                    n_sparse = 1
                rng = np.random.default_rng(vr % 1000 + rows)
                sparse = rng.integers(-(2**31), 2**31, (rows, n_sparse), dtype=np.int64)
                sparse[:3].flat[:3] = [-(2**31), 2**31 - 1, -1]
                sparse.flat[-1] = vr - 1
                dense = rng.integers(-500, 10**6, (rows, n_dense))
                sp = torch.from_numpy(sparse.astype(np.int32)).to(self.dev)
                de = torch.from_numpy(dense.astype(np.int32)).to(self.dev)
                table = torch.randint(0, 2**31 - 1, (n_sparse, vr), dtype=torch.int32,
                                      device=self.dev)
                vocab = vocab_lib.Vocabulary(table=table,
                                             sizes=torch.zeros(n_sparse, dtype=torch.int32))
                got = fxops.fused_transform(vocab, sp, de)
                again = fxops.fused_transform(vocab, sp, de)
                want = fxref.fused_transform(table, sp, de)
                mod = fxops.fused_mod_dense(sp, de, vocab_range=vr)
                mod_want = fxref.fused_mod_dense(sp, de, vr)
                self.sync()
                ok = (torch.equal(got[0], want[0]) and torch.equal(got[0], again[0])
                      and torch.equal(got[1], again[1])
                      and torch.allclose(got[1], want[1], rtol=1e-6, atol=0)
                      and torch.equal(mod[0], mod_want[0])
                      and torch.allclose(mod[1], want[1], rtol=1e-6, atol=0))
                records.append({"kernel": "fused_transform", "V": vr, "rows": rows,
                                "n_sparse": n_sparse, "n_dense": n_dense, "ok": bool(ok)})
                del table, vocab
        return records

    # -- times ---------------------------------------------------------- #
    def timed(self, fn, reps: int = 20, library=None) -> dict:
        """Event and profiler times of ``fn`` (and of ``library``)."""
        rec = {"event_ms": self.event_ms(fn, reps)}
        dev = self.device_ms([fn] * reps)
        if dev is not None:
            per_call = self.kernels_per_call(fn)
            rec.update(device_ms=dev["total"], stages=dev["by_name"], kernels_per_call=per_call,
                       launches_per_call=sum(per_call.values()))
        if library is not None:
            lib = self.device_ms([library] * reps)
            rec["library_event_ms"] = self.event_ms(library, reps)
            if lib is not None:
                rec["library_device_ms"] = lib["total"]
        return rec

    def times(self, mods, chunks) -> dict:
        torch, np, dev = self.torch, self.np, self.dev
        dops, fxops, fdvops, fdxops, vocab_lib, core_ops = mods
        from repro_torch.core.uint32 import as_u32

        hex_t = np.arange(N_FIELDS) > N_DENSE
        kw = dict(n_fields=N_FIELDS, max_rows=MAX_ROWS, n_dense=N_DENSE, n_sparse=N_SPARSE)
        buf = torch.from_numpy(chunks[0]).to(dev)
        n = buf.numel()
        out_bytes = MAX_ROWS * (4 * N_FIELDS + 1)
        times = {}

        def add(name, rec_fn):
            if self.only is None or name.partition("@")[0] in self.only:
                times[name] = rec_fn()
                emit({"time": {name: times[name]}})

        add("decode_scan", lambda: {
            "shape": f"{n} B chunk, max_rows {MAX_ROWS}",
            "bound_ms": (n + out_bytes) / HBM_BYTES_PER_S * 1e3,
            **self.timed(lambda: dops.decode(buf, hex_t, **kw), reps=20)})
        # decode at the other chunk sizes a pipeline may pick, and on the
        # smoke's hostile chunks (2 MB of 4136-byte fields at most)
        for tag, arr, max_rows in self.sized + self.hostile():
            b = torch.from_numpy(arr).to(dev)
            hkw = dict(kw, max_rows=max_rows)
            add(f"decode_scan@{tag}", lambda: {
                "shape": f"{b.numel()} B chunk, max_rows {max_rows}",
                "bound_ms": (b.numel() + max_rows * (4 * N_FIELDS + 1)) / HBM_BYTES_PER_S * 1e3,
                **self.timed(lambda: dops.decode(b, hex_t, **hkw), reps=20)})

        _, dense, sparse, valid = dops.decode(buf, hex_t, **kw)
        rows = sparse.shape[0]
        fkw = dict(n_fields=N_FIELDS, hex_start=1 + N_DENSE)
        col = torch.arange(N_SPARSE, device=dev)[None, :]
        io = rows * (N_SPARSE + N_DENSE) * 4 * 2
        for tag, vr in (REHEARSAL_RANGES if self.rehearse else RANGES).items():
            state = vocab_lib.VocabState.init(N_SPARSE, vr, device=dev)
            for c in chunks[1:3]:
                b = dops.decode(torch.from_numpy(c).to(dev), hex_t, **kw)
                state = core_ops.fused_vocab_update(state, b[2], b[3], use_kernel=False)
            vocab = vocab_lib.finalize(state)
            modded = as_u32(sparse) % vr
            slots = (col * vr + modded).reshape(-1)
            touched = int(torch.unique(slots).numel())
            sectors = int(torch.unique(slots // (SECTOR // 4)).numel())
            idx_t = modded.t().contiguous()
            add(f"fused_transform@{tag}", lambda: {
                "shape": f"sparse [{rows}, {N_SPARSE}], dense [{rows}, {N_DENSE}], V={vr}",
                "touched_slots": touched, "touched_sectors": sectors,
                "bound_ms": (io + touched * 4) / HBM_BYTES_PER_S * 1e3,
                "bound_ms_by_sectors": (io + sectors * SECTOR) / HBM_BYTES_PER_S * 1e3,
                **self.timed(lambda: fxops.fused_transform(vocab, sparse, dense),
                             library=lambda: torch.gather(vocab.table, 1, idx_t))})
            add(f"fused_mod_dense@{tag}", lambda: {
                "bound_ms": io / HBM_BYTES_PER_S * 1e3,
                **self.timed(lambda: fxops.fused_mod_dense(sparse, dense, vocab_range=vr))})
            st = vocab_lib.VocabState(state.first_pos.clone(), state.rows_seen.clone())
            add(f"fused_decode_genvocab@{tag}", lambda: self.timed(
                lambda: fdvops.fused_decode_update(st, buf, max_rows=MAX_ROWS, **fkw)))
            add(f"fused_decode_transform@{tag}", lambda: self.timed(
                lambda: fdxops.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw)))
            for size, arr, max_rows in self.sized + self.hostile()[:2]:
                b = torch.from_numpy(arr).to(dev)
                add(f"fused_decode_genvocab@{tag}/{size}", lambda: {
                    "shape": f"{b.numel()} B chunk, max_rows {max_rows}",
                    **self.timed(lambda: fdvops.fused_decode_update(
                        st, b, max_rows=max_rows, **fkw))})
                add(f"fused_decode_transform@{tag}/{size}", lambda: {
                    "shape": f"{b.numel()} B chunk, max_rows {max_rows}",
                    **self.timed(lambda: fdxops.fused_decode_transform(
                        vocab, b, max_rows=max_rows, **fkw))})
        return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--time-only", action="store_true", help="skip the checks")
    ap.add_argument("--only", default=None,
                    help="time only these kernels (comma-separated names), after the checks")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("torch_decode_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))  # chip_smoke's hostile rows
    from repro_torch.core import ops as core_ops, vocab as vocab_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_utf8 import ops as dops, ref as dref
    from repro_torch.kernels.fused_decode_vocab import ops as fdvops, ref as fdvref
    from repro_torch.kernels.fused_decode_xform import ops as fdxops, ref as fdxref
    from repro_torch.kernels.fused_xform import ops as fxops, ref as fxref

    dev = torch.device("cpu" if args.rehearse else "cuda")
    bench = DecodeBench(torch, np, dev, args.rehearse)
    records = {"label": args.label, "src": args.src}
    if not args.rehearse:
        records["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        t0 = time.perf_counter()
        paths = _build.build(SOURCES)
        records["build"] = {"seconds": time.perf_counter() - t0, "ptxas": {
            name: ptxas_entries(Path(f"{path}.log").read_text()) for name, path in paths.items()}}
        emit({"build": records["build"]})

    t0 = time.perf_counter()
    chunks = bench.data()
    emit({"data_seconds": time.perf_counter() - t0})
    failed = []
    records["checks"] = []
    if not args.time_only:
        for rec in (bench.check_decode(dops, dref, chunks)
                    + bench.check_decode_xform(fdxops, fdxref, vocab_lib, chunks)
                    + bench.check_decode_genvocab(fdvops, fdvref, vocab_lib, chunks)
                    + bench.check_xform(fxops, fxref, vocab_lib)):
            records["checks"].append(rec)
            if not rec["ok"]:
                failed.append(rec)
                emit({"check": rec})
    emit({"checks_passed": len(records["checks"]) - len(failed), "checks": len(records["checks"])})
    if failed:
        emit({"failed": failed})
        return 1

    bench.only = set(args.only.split(",")) if args.only else None
    records["times"] = bench.times((dops, fxops, fdvops, fdxops, vocab_lib, core_ops), chunks)
    floor = bench.launch_floor(_build)
    records["launch_floor"] = floor
    emit({"launch_floor": floor})
    records["failed"] = failed
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))
    emit(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
