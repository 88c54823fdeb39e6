#!/usr/bin/env python3
"""Wall time of the port's two loops on two source trees, in one run.

    python3 tools/torch_loop_ab.py --compare OLD_SRC NEW_SRC [--rounds 2] [--reps 15]
    python3 tools/torch_loop_ab.py --compare OLD_SRC NEW_SRC --rehearse   # CPU, tiny

Each ``*_SRC`` is a ``src/`` directory that holds a ``repro_torch`` package,
e.g. the one of this checkout and the one of a commit unpacked with
``git archive``. The two trees run alternately, each in a fresh process,
in the order old, new, new, old, repeated ``--rounds`` times, so that a
drift of the card or the host falls on both alike. Every process runs the
default configuration (``PipelineConfig`` with its hints left at None) at
CRITEO (5K) and CRITEO_1M, on a utf8 feed of 2^18 rows in 1 MiB chunks and
on a binary feed of 2^22 rows in 16384-row chunks, the feeds of
chip_smoke.py's main phase. It runs each loop once to warm up, then
``--reps`` more times, each timed on the host clock and ending in a
synchronize: loop ① is ``build_state_stream``, loop ② ``transform_stream``.

The data is made once, from fixed seeds, by the first process and kept in
``--data-cache`` (under build/, which git ignores) for the others. The last
line printed is a JSON object: per tree, range, feed and loop, the pooled
repeats' median rows/s, and the new tree's median over the old one's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RANGES = {"5K": 5000, "1M": 1_000_000}
CHUNK_BYTES = 1 << 20
MAX_ROWS = 1 << 14
ROWS = {"utf8": 1 << 18, "binary": 1 << 22}
REHEARSAL_ROWS = {"utf8": 2000, "binary": 20000}


def load_data(np, cache: Path, rows: dict) -> dict:
    """The two feeds' host arrays, made once and then read from ``cache``."""
    from repro_torch.data import synth

    if cache.exists():
        z = np.load(cache)
        if int(z["utf8_rows"]) == rows["utf8"] and int(z["binary_rows"]) == rows["binary"]:
            return {k: z[k] for k in z.files}
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows["utf8"], seed=0))
    binary = synth.generate_binary(synth.SynthConfig(rows=rows["binary"], seed=1))
    data = {"utf8_buf": buf, "label": binary["label"], "dense": binary["dense"],
            "sparse": binary["sparse"], "utf8_rows": np.int64(rows["utf8"]),
            "binary_rows": np.int64(rows["binary"])}
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, **data)
    return data


def run_tree(args) -> dict:
    """Time both loops of one tree; returns {range: {feed: {loop: [s, ...]}}}."""
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import pipeline as P
    from repro_torch.core import schema as schema_lib, vocab as vocab_lib
    from repro_torch.data import loader, synth

    src = Path(repro_torch.__file__).resolve()
    if Path(args.src).resolve() not in src.parents:
        raise SystemExit(f"imported {src}, not the package under {args.src}")
    dev = "cpu" if args.rehearse else "cuda"
    rows = REHEARSAL_ROWS if args.rehearse else ROWS
    data = load_data(np, Path(args.data_cache), rows)
    utf8_chunks = list(synth.chunk_stream(data["utf8_buf"], CHUNK_BYTES))
    flat = loader.BinaryChunkFeed(
        {k: data[k] for k in ("label", "dense", "sparse")}, MAX_ROWS).flat_chunks()
    binary_chunks = [{k: v[i] for k, v in flat.items()} for i in range(len(flat["label"]))]

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def wall(fn, n):
        times = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return times

    out = {}
    for tag, vr in RANGES.items():
        sch = dataclasses.replace(schema_lib.CRITEO, vocab_range=vr)
        out[tag] = {}
        for feed, chunks in (("utf8", utf8_chunks), ("binary", binary_chunks)):
            pipe = P.PiperPipeline(P.PipelineConfig(schema=sch, input_format=feed, device=dev))
            state = pipe.build_state_stream(chunks)
            vocab = vocab_lib.finalize(state)
            list(pipe.transform_stream(vocab, chunks))
            n = 1 if args.rehearse else args.reps
            out[tag][feed] = {
                "loop1": wall(lambda: pipe.build_state_stream(chunks), n),
                "loop2": wall(lambda: list(pipe.transform_stream(vocab, chunks)), n),
            }
            del pipe, state, vocab
    return {"src": str(Path(args.src).resolve()), "rows": rows, "seconds": out}


def compare(args) -> dict:
    """Run the two trees alternately, each in a fresh process, and pool."""
    old, new = args.compare
    order = ["old", "new", "new", "old"] * args.rounds
    trees = {"old": old, "new": new}
    pooled, runs_out = {"old": [], "new": []}, []
    for i, which in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--src", trees[which],
               "--reps", str(args.reps), "--data-cache", args.data_cache]
        if args.rehearse:
            cmd.append("--rehearse")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"run {i} ({which}, {trees[which]}) exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        pooled[which].append(res)
        runs_out.append({"run": i, "tree": which, "process_s": time.perf_counter() - t0, **res})
        print(json.dumps(runs_out[-1]), flush=True)

    summary = {}
    for tag in RANGES:
        for feed in ("utf8", "binary"):
            for loop in ("loop1", "loop2"):
                med = {}
                for which, runs in pooled.items():
                    reps = [s for r in runs for s in r["seconds"][tag][feed][loop]]
                    rows = runs[0]["rows"][feed]
                    med[which] = rows / statistics.median(reps)
                summary[f"{tag} {feed} {loop}"] = {
                    "old_rows_per_s_median": med["old"], "new_rows_per_s_median": med["new"],
                    "new_over_old": med["new"] / med["old"]}
    return {"order": order, "reps_per_process": args.reps, "old": old, "new": new,
            "summary": summary, "runs": runs_out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", nargs=2, metavar=("OLD_SRC", "NEW_SRC"))
    ap.add_argument("--src", help="time one tree in this process (used by --compare)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--data-cache", default=str(ROOT / "build" / "loop_ab_data.npz"))
    ap.add_argument("--out", help="also write the summary and every run's times to this JSON file")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a tiny size (checks the script, times nothing)")
    args = ap.parse_args(argv)
    if args.src:
        print(json.dumps(run_tree(args)), flush=True)
        return 0
    if not args.compare:
        ap.error("give --compare OLD_SRC NEW_SRC")
    if not args.rehearse:
        import torch

        if not torch.cuda.is_available():
            print("torch_loop_ab: no CUDA device; nothing was run", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(smi, flush=True)
    result = {"nvidia_smi": smi if not args.rehearse else "cpu rehearsal", **compare(args)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
