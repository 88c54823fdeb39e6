"""End-to-end launcher: Piper preprocessing → DLRM training (the paper's
Figure 2 system in one program), streamed and overlapped.

Counterpart of ``examples/train_dlrm_e2e.py``. Training pulls its batches
from the :class:`~repro_torch.stream.StreamingPreprocessService` through
the :class:`~repro_torch.train.input_pipeline.TrainInputPipeline` bridge:
raw utf8 payloads are preprocessed on the fly (loop ② on the card),
assembled into fixed-shape batches, staged onto the card while the train
step of an earlier batch runs, and cached content-addressed
(:class:`~repro_torch.data.chunk_cache.ChunkCache`), so a second epoch
skips preprocessing. Loop ①'s state is built offline first. The loss is
read one step lagged, so the host never waits for the step it just
queued.

At exit it prints the e2e stall split (input_wait vs train_step), the
service's stall buckets and the cache counters.

    python -m repro_torch.launch.train_dlrm_e2e [--steps 300] [--config 5K]
        [--no-overlap] [--cache-mb 64] [--prefetch-depth 2] [--trace out.json]
        [--device cpu]

Without ``--config`` it trains the example's small DLRM; ``--config 5K``
or ``1M`` trains that Piper DLRM configuration at full width. It runs on
the card unless ``--device cpu`` is given, and raises without one.
:func:`prepare` and :func:`train` are the same work as functions that
return their results, for callers that drive several runs over one feed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import piper_dlrm
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.data import chunk_cache as chunk_cache_lib
from repro_torch.data import synth
from repro_torch.models import dlrm
from repro_torch.stream import StreamingPreprocessService
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import input_pipeline as input_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib

CONFIGS = {"5K": piper_dlrm.CONFIG_5K, "1M": piper_dlrm.CONFIG_1M}
CKPT_EVERY = 100  # steps between checkpoints, as the reference's example


@dataclasses.dataclass
class Feed:
    """What every run over one dataset shares: the pipeline config, loop
    ①'s un-finalized state over the whole feed, and the payloads of
    ``payload_rows`` consecutive rows each, in row order."""

    config: pipeline_lib.PipelineConfig
    state: vocab_lib.VocabState
    payloads: list
    payload_rows: int
    loop1_s: float


def prepare(buf: np.ndarray, schema: schema_lib.TableSchema, *, payload_rows: int,
            device="cuda") -> Feed:
    """Loop ① over the utf8 feed ``buf`` (offline, the pipeline's default
    chunks), and the feed cut into payloads of ``payload_rows`` rows (the
    rows past the last whole payload are left out)."""
    config = pipeline_lib.PipelineConfig(schema=schema, device=str(device))
    t0 = time.perf_counter()
    state = pipeline_lib.PiperPipeline(config).build_state_stream(
        synth.chunk_stream(buf, config.chunk_bytes))
    if config.torch_device.type == "cuda":
        torch.cuda.synchronize(config.torch_device)
    loop1_s = time.perf_counter() - t0
    n_rows = len(synth.row_spans(buf))
    if payload_rows < 1 or payload_rows > n_rows:
        raise ValueError(f"payload_rows must be in [1, {n_rows}], got {payload_rows}")
    payloads = list(synth.request_payloads(buf, None, [payload_rows] * (n_rows // payload_rows)))
    return Feed(config, state, payloads, payload_rows, loop1_s)


def start_service(feed: Feed, cache: chunk_cache_lib.ChunkCache | None = None):
    """The streaming service over ``feed``'s state, one bucket of
    ``payload_rows`` rows, started."""
    return StreamingPreprocessService(feed.config, feed.state, bucket_rows=(feed.payload_rows,),
                                      cache=cache).start()


def train(service, feed: Feed, model_cfg: dlrm.DLRMConfig, opt_cfg: opt_lib.AdamWConfig, *,
          steps: int, batch: int, overlap: bool = True, prefetch_depth: int = 2, seed: int = 0,
          ckpt_dir: str | None = None) -> tuple[dict, dlrm.DLRM]:
    """``steps`` train steps of a DLRM initialised from ``seed``, fed by
    ``service`` through the input bridge. Returns ``(report, model)``:
    the report holds the losses, the wall time, rows/s, the e2e and the
    service's stall splits, the cache counters and the checkpoints taken
    (every ``CKPT_EVERY`` steps under ``ckpt_dir``, when it is given)."""
    device = feed.config.torch_device
    gen = torch.Generator(device).manual_seed(seed)
    model = dlrm.DLRM(model_cfg, device=device, generator=gen)
    opt_state = opt_lib.adamw_init(model.params_tree())
    step = steps_lib.make_tabular_train_step(dlrm.loss, opt_cfg)
    ckpt = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=2) if ckpt_dir else None
    pipe_in = input_lib.TrainInputPipeline(
        service, lambda: iter(feed.payloads), batch_rows=batch, n_steps=steps,
        overlap=overlap, prefetch_depth=prefetch_depth, device=device)
    losses: list[float] = []
    pending = None  # step i's loss is read while step i+1 runs
    i = 0
    t0 = time.perf_counter()
    for b in pipe_in:
        for k, v in b.items():
            if v.device.type != device.type:
                raise RuntimeError(f"batch field {k} is on {v.device}, not on {device}")
        metrics = step(model, opt_state, b)
        if pending is not None:
            losses.append(float(pending))
        pending = metrics["loss"]
        i += 1
        if ckpt is not None and i % CKPT_EVERY == 0:
            losses.append(float(pending))  # drain before the snapshot
            pending = None
            ckpt.save_async(i, {"params": model.params_tree(), "opt": opt_state})
    if pending is not None:
        losses.append(float(pending))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    if ckpt is not None:
        ckpt.wait()
    reg = service.registry
    report = {
        "steps": steps, "batch_rows": batch, "overlap": overlap, "device": str(device),
        "wall_s": wall_s, "ms_per_step": wall_s / steps * 1e3,
        "rows_per_s": steps * batch / wall_s, "losses": losses,
        "e2e_stall": pipe_in.stall_report(),
        "e2e_counters": {n: pipe_in.registry.get(f"e2e.{n}").value
                         for n in ("batches_total", "rows_total", "epochs_total")},
        "service_stall": service.stall_report(),
        "service_batches": reg.get("stream.batches_total").value,
        "cache": service.cache.stats() if service.cache is not None else None,
        "checkpoints": ckpt_lib.list_steps(ckpt_dir) if ckpt_dir else [],
    }
    return report, model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=8_192)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=5_000,
                    help="vocab range of the small DLRM (ignored with --config)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default=None,
                    help="train a Piper DLRM configuration at full width instead")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_dlrm_ckpt"))
    ap.add_argument("--no-overlap", action="store_true",
                    help="stage batches synchronously inside next() (the stall baseline)")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--cache-mb", type=int, default=64,
                    help="chunk-cache capacity in MiB (0 disables the cache)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Perfetto trace of the run and a metrics snapshot "
                    "(OUT.metrics.json)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()  # the process tracer; off again when the run ends
    try:
        if args.config:
            schema, model_cfg = CONFIGS[args.config].schema, CONFIGS[args.config].model
        else:
            schema = dataclasses.replace(schema_lib.CRITEO, vocab_range=args.vocab)
            # bottom_mlp ends at embed_dim: the dense vector joins the
            # per-table embeddings in the pairwise interaction
            model_cfg = dlrm.DLRMConfig(vocab_range=args.vocab, embed_dim=16,
                                        bottom_mlp=(128, 64, 16), top_mlp=(128, 64, 1))
        buf, _ = synth.make_dataset(synth.SynthConfig(schema=schema, rows=args.rows, seed=0))
        feed = prepare(buf, schema, payload_rows=min(args.batch, args.rows), device=args.device)
        cache = (chunk_cache_lib.ChunkCache(capacity_bytes=args.cache_mb << 20)
                 if args.cache_mb > 0 else None)
        service = start_service(feed, cache)
        print(f"Piper loop ① over {args.rows} rows in {feed.loop1_s:.2f}s; streaming loop ② "
              f"from here on (cache={'off' if cache is None else f'{args.cache_mb}MiB'}, "
              f"on {feed.config.torch_device})")
        ocfg = opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(2e-3, 20, args.steps),
                                   weight_decay=0.0)
        try:
            report, _ = train(service, feed, model_cfg, ocfg, steps=args.steps,
                              batch=args.batch, overlap=not args.no_overlap,
                              prefetch_depth=args.prefetch_depth, ckpt_dir=args.ckpt_dir)
        finally:
            service.stop()
    finally:
        if args.trace:
            obs.disable()

    losses = report["losses"]
    head = max(1, min(20, len(losses) // 2))
    first, last = float(np.mean(losses[:head])), float(np.mean(losses[-head:]))
    print(f"trained {args.steps} steps in {report['wall_s']:.1f}s "
          f"({report['rows_per_s']:.0f} rows/s); loss {first:.4f} → {last:.4f}")
    e2e = report["e2e_stall"]
    print(f"e2e stall split: input_wait={e2e['fractions']['input_wait']:.1%} "
          f"train_step={e2e['fractions']['train_step']:.1%} "
          f"(attributed {e2e['attributed_s']:.2f}s of {e2e['wall_s']:.2f}s wall)")
    print(f"service stall buckets: {report['service_stall']['fractions']}")
    if cache is not None:
        st = report["cache"]
        print(f"chunk cache: {st['hits_total']} hits / {st['misses_total']} misses "
              f"({st['items']} resident, {st['mem_bytes'] / 2**20:.1f} MiB)")
    if args.trace:
        obs.tracer().export(args.trace)
        mpath = args.trace.replace(".json", "") + ".metrics.json"
        with open(mpath, "a") as f:
            f.write(json.dumps({k: report[k] for k in ("e2e_stall", "e2e_counters",
                                                        "service_stall", "cache")}) + "\n")
        print(f"wrote {args.trace} + {mpath}")
    print(f"checkpoints at {args.ckpt_dir}: steps {report['checkpoints']}")
    if not last < first:
        raise RuntimeError(f"the loss did not fall ({first:.4f} → {last:.4f})")
    return report


if __name__ == "__main__":
    main()
