"""Serving launcher: continuous-batching demo on a smoke config.

Counterpart of ``repro/launch/serve.py``:

    python -m repro_torch.launch.serve --arch gemma-2b --requests 8
    python -m repro_torch.launch.serve --arch gemma-2b --device cpu

``--piper-stream`` runs the *preprocessing* serving demo instead: the
online streaming service (``repro_torch.stream``) over a synthetic Criteo
stream — offline loop ① freezes the vocabulary, then randomized-size
requests flow through the bucketed micro-batch scheduler and the
latency/throughput metrics are printed:

    python -m repro_torch.launch.serve --piper-stream --rows 4096

Both run on the card unless ``--device cpu`` is given, and raise without
one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm as lm_lib
from repro_torch.serve import engine as engine_lib


def run_piper_stream(args) -> dict:
    """Streaming preprocessing service demo (Piper-as-a-service): the
    reference's dataset, bucket ladder and request sizes."""
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.data import synth
    from repro_torch.stream import StreamingPreprocessService

    cfg = synth.SynthConfig(rows=args.rows, seed=0)
    buf, _ = synth.make_dataset(cfg)
    pc = pipeline_lib.PipelineConfig(schema=cfg.schema, device=args.device)
    pipe = pipeline_lib.PiperPipeline(pc)
    state = pipe.build_state_stream(synth.chunk_stream(buf, 1 << 14))

    rng = np.random.default_rng(0)
    buckets = (256, 1024, 4096)
    sizes, left = [], args.rows
    while left > 0:
        n = int(min(rng.integers(1, 512), left))
        sizes.append(n)
        left -= n
    svc = StreamingPreprocessService(pc, state, bucket_rows=buckets, queue_depth=32).start()
    try:
        # warm every bucket so the printed latencies are steady-state
        svc.warmup(
            next(synth.request_payloads(buf, None, [min(c, args.rows)]))
            for c in buckets
        )
        for p in synth.request_payloads(buf, None, sizes):
            svc.submit(p)
        svc.drain()
        snap = svc.metrics.snapshot()
    finally:
        svc.stop()
    print(
        f"streamed {snap['requests']} requests / {snap['rows']} rows in "
        f"{snap['wall_s']:.2f}s — {snap['rows_per_s']:.0f} rows/s, "
        f"p50={snap['p50_ms']}ms p95={snap['p95_ms']}ms p99={snap['p99_ms']}ms "
        f"({svc.compile_cache_size()} compiled shapes, on {pc.torch_device})"
    )
    return snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument(
        "--piper-stream",
        action="store_true",
        help="run the streaming preprocessing service demo instead of LM serving",
    )
    ap.add_argument("--rows", type=int, default=4096, help="--piper-stream dataset size")
    args = ap.parse_args(argv)

    if args.piper_stream:
        return run_piper_stream(args)

    cfg = configs.get_smoke(args.arch)
    if cfg.family == "audio":
        raise SystemExit("use a decoder-only arch for the serve demo")
    model = lm_lib.LM(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = engine_lib.ServeEngine(model, params, batch_slots=args.slots, cache_len=args.cache_len)
    rng = np.random.default_rng(0)
    reqs = [
        engine_lib.Request(
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {cfg.name} on {model.device})")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
