"""Serving launcher: continuous-batching demo on a smoke config.

Counterpart of the LM half of ``repro/launch/serve.py``:

    python -m repro_torch.launch.serve --arch gemma-2b --requests 8
    python -m repro_torch.launch.serve --arch gemma-2b --device cpu

It runs on the card unless ``--device cpu`` is given, and raises without
one.
The reference's ``--piper-stream`` demo comes with the streaming service
(ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm as lm_lib
from repro_torch.serve import engine as engine_lib


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
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
