"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``: the fault-tolerant trainer
(``train/trainer.py``) on an LM architecture, by default its reduced
(smoke) config; ``--full`` takes the published config and, as the
reference, turns remat off::

    python -m repro_torch.launch.train --arch gemma-2b --device cpu --steps 20
    python -m repro_torch.launch.train --arch gemma-2b --full --seq 4096 \\
        --batch 4 --microbatches 2 --steps 4 --ckpt-dir build/lm_ckpt

The data source is Piper: a synthetic Criteo-format stream goes through
the two-loop engine on the same device, and its vocabulary-encoded
ordinals feed the LM as token windows (``data/loader.PiperTokenBatches``).
The audio and vision architectures also get the reference's seeded stub
inputs a step (``frames``, ``vision``: normal · 0.1).
It runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.data import loader, synth
from repro_torch.launch import specs as specs_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib

CHUNK_BYTES = 1 << 17
MAX_ROWS_PER_CHUNK = 2048


def token_chunks(schema_rows: int, seed: int = 0):
    """``(schema, chunks)``: the synthetic Criteo stream that
    :func:`preprocess_tokens` reads, as its byte chunks."""
    scfg = synth.SynthConfig(rows=schema_rows, seed=seed)
    buf, _ = synth.make_dataset(scfg)
    return scfg.schema, list(synth.chunk_stream(buf, CHUNK_BYTES))


def preprocess_tokens(schema_rows: int, seed: int = 0, device="cuda") -> np.ndarray:
    """Piper's two loops on ``device`` → the LM token stream: the sparse
    ordinals of the valid rows, int32 ``[rows, n_sparse]`` on the host.
    ``PiperTokenBatches`` takes them modulo the model's vocabulary."""
    schema, chunks = token_chunks(schema_rows, seed)
    pipe = pipeline_lib.PiperPipeline(pipeline_lib.PipelineConfig(
        schema=schema, max_rows_per_chunk=MAX_ROWS_PER_CHUNK, device=device))
    sparse = [out.sparse[out.valid].cpu().numpy()
              for out in pipe.run_stream(lambda: iter(chunks))]
    return np.concatenate(sparse)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config, remat off")
    ap.add_argument("--rows", type=int, default=2048, help="synthetic dataset rows")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    model = specs_lib.build_model(cfg, remat=not args.full, device=args.device)

    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M remat={model.remat} "
          f"on {model.device}")
    print("preprocessing synthetic Criteo stream through PIPER...")
    sparse = preprocess_tokens(args.rows, device=args.device)
    base_fn = loader.PiperTokenBatches(sparse, cfg.vocab_size, args.batch, args.seq)

    def batch_fn(step: int) -> dict:
        """Piper's tokens, and the reference's seeded stub inputs: frames
        for the audio family, patch embeddings for a vision LM."""
        batch = dict(base_fn(step))
        rng = np.random.default_rng((1234, step))
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (args.batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.vision_tokens:
            batch["vision"] = rng.standard_normal(
                (args.batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.1
        return batch

    tcfg = trainer_lib.TrainerConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
    )
    opt_cfg = opt_lib.AdamWConfig(
        schedule=opt_lib.cosine_schedule(args.lr, args.steps // 10 + 1, args.steps)
    )
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = trainer_lib.Trainer(model, opt_cfg, tcfg, batch_fn)
    out = trainer.run(0)
    losses = out["losses"]
    print(
        f"done: step={out['final_step']} loss {losses[0]:.3f} → {losses[-1]:.3f} "
        f"({np.mean(out['step_times']):.2f}s/step, {out['stragglers']} stragglers)"
    )
    if model.device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"peak device memory {out['peak_memory_bytes'] / 2**30:.2f} GiB")
    return out


if __name__ == "__main__":
    main()
