#!/usr/bin/env python3
"""Where the trainer's host time goes when the streaming service feeds it.

    python3 tools/torch_e2e_profile.py [--range 5K] [--steps 50] [--switch-ms 5,0.5]
                                       [--torch-threads 0,1] [--out F.json]
    python3 tools/torch_e2e_profile.py --rehearse      # CPU, tiny

Runs launch/train_dlrm_e2e's functions as chip_smoke.py's e2e phase does:
loop ① over the smoke's 2^18-row utf8 feed (seed 0), a streaming service
with one bucket of 4096 rows, payloads of 4096 consecutive rows, the
range's Piper DLRM at full width with AdamW's defaults. Three modes:
overlap off, overlap on, and overlap off on a chunk cache that a first,
unrecorded pass filled (every request a hit). Each mode runs under every
pair of ``--torch-threads`` (``torch.set_num_threads``, the pool that
PyTorch's CPU ops, such as a copy into a pinned buffer, split their work
over; 0 leaves PyTorch's default) and interpreter switch interval of
``--switch-ms`` (``sys.setswitchinterval``: how long a thread that wants
the interpreter lock waits before the holder is asked to drop it). Each
run reports ms per step on the host clock up
to a synchronize, the e2e stall split, and the host seconds a step spends
in each of the input's calls, by the thread that made them: the service's
``submit`` (which hashes the payload when a cache is set), the wait in a
request's ``result``, ``PinnedStager.stage`` (the pinned copy and the
copies in), and the train step's own call (its launches; the lagged loss
read is outside it). Each is a wrapper around the call, two clock reads
each. The last line printed is a JSON object of every run.
``--rehearse`` checks the plumbing on the CPU at a tiny size and times
nothing a card would.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROWS, BATCH = 1 << 18, 4096
REHEARSAL = {"rows": 3000, "batch": 256, "steps": 8}


class CallClock:
    """Host seconds and calls of wrapped functions, by (name, thread)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                key = (name, threading.current_thread().name)
                with self.lock:
                    self.seconds[key] += time.perf_counter() - t0
                    self.calls[key] += 1
        return timed

    def take(self, steps: int) -> list:
        """ms a step by (name, thread), and resets."""
        with self.lock:
            out = [{"call": n, "thread": t, "calls": self.calls[(n, t)],
                    "ms_per_step": s / steps * 1e3} for (n, t), s in self.seconds.items()]
            self.seconds.clear()
            self.calls.clear()
        return sorted(out, key=lambda r: -r["ms_per_step"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--range", choices=("5K", "1M"), default="5K")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--switch-ms", default="5,0.5",
                    help="interpreter switch intervals to run under, in ms")
    ap.add_argument("--torch-threads", default="0",
                    help="torch.set_num_threads values to run under (0: the default)")
    ap.add_argument("--out", default=None, help="also write the result to this JSON file")
    ap.add_argument("--rehearse", action="store_true",
                    help="check the plumbing on the CPU at a tiny size")
    args = ap.parse_args(argv)

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("torch_e2e_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import piper_dlrm
    from repro_torch.data import chunk_cache, loader, synth
    from repro_torch.launch import train_dlrm_e2e
    from repro_torch.stream import StreamingPreprocessService, scheduler
    from repro_torch.train import optimizer, steps as steps_lib

    clock = CallClock()
    StreamingPreprocessService.submit = clock.wrap("submit", StreamingPreprocessService.submit)
    scheduler.StreamRequest.result = clock.wrap("result", scheduler.StreamRequest.result)
    loader.PinnedStager.stage = clock.wrap("stage", loader.PinnedStager.stage)
    make_step = steps_lib.make_tabular_train_step
    steps_lib.make_tabular_train_step = lambda *a: clock.wrap("train_step", make_step(*a))

    device = "cpu" if args.rehearse else "cuda"
    rows, batch, steps = ROWS, BATCH, args.steps
    cfg = {"5K": piper_dlrm.CONFIG_5K, "1M": piper_dlrm.CONFIG_1M}[args.range]
    if args.rehearse:
        rows, batch, steps = REHEARSAL["rows"], REHEARSAL["batch"], REHEARSAL["steps"]
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_range=5000),
                                  schema=dataclasses.replace(cfg.schema, vocab_range=5000))
    torch.backends.cuda.matmul.allow_tf32 = False
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows, seed=0))
    feed = train_dlrm_e2e.prepare(buf, cfg.schema, payload_rows=batch, device=device)
    ocfg = optimizer.AdamWConfig()
    plain = train_dlrm_e2e.start_service(feed)
    cached = train_dlrm_e2e.start_service(feed, chunk_cache.ChunkCache(256 << 20))
    info = {"range": args.range, "steps": steps, "batch_rows": batch, "device": device}
    if not args.rehearse:
        import subprocess

        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = []
    default_switch, default_threads = sys.getswitchinterval(), torch.get_num_threads()
    info.update(default_switch_ms=default_switch * 1e3, default_torch_threads=default_threads)
    try:
        train_dlrm_e2e.train(cached, feed, cfg.model, ocfg, steps=steps, batch=batch,
                             overlap=False)  # fills the cache; not recorded
        cached.drain(timeout=300)
        for threads, switch_ms in ((int(t), float(x)) for t in args.torch_threads.split(",")
                                   for x in args.switch_ms.split(",")):
            torch.set_num_threads(threads or default_threads)
            sys.setswitchinterval(switch_ms / 1e3)
            for mode, svc, overlap in (("overlap_off", plain, False),
                                       ("overlap_on", plain, True),
                                       ("overlap_off_warm_cache", cached, False)):
                svc.drain(timeout=300)
                svc.registry.reset()  # this run's service stall split alone
                clock.take(steps)
                report, _ = train_dlrm_e2e.train(svc, feed, cfg.model, ocfg, steps=steps,
                                                 batch=batch, overlap=overlap)
                rec = {"mode": mode, "switch_ms": switch_ms,
                       "torch_threads": torch.get_num_threads(), "ms_per_step": report["ms_per_step"],
                       "rows_per_s": report["rows_per_s"], "e2e_stall": report["e2e_stall"],
                       "service_stall": report["service_stall"]["fractions"],
                       "calls": clock.take(steps)}
                print(json.dumps(rec), flush=True)
                runs.append(rec)
    finally:
        sys.setswitchinterval(default_switch)
        torch.set_num_threads(default_threads)
        plain.stop()
        cached.stop()
    out = {**info, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
