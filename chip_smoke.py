#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,golden,main,sharded,stream,train,serve,e2e,lm_train,
                                    zoo,cross,sharded_train,analysis]
                          [--out results.json]
    python3 chip_smoke.py --rehearse      # plumbing only, on the CPU

Phases, each of which passes or ends the run with a non-zero exit:
  1. device — the card's name, count, torch and CUDA versions, then the
     build of every kernel source in src/repro_torch/kernels/csrc (one
     nvcc per source, all at once), timed, with the registers and spills
     ptxas reported for the bf16 wgmma flash-attention kernel at head_dim
     256 (gemma-2b's), which must not spill, and at 128 and 64
     (qwen2-moe's and hymba's), reported only.
  2. kernels — each kernel wrapper on tensors on the card, at the main
     path's shapes, against its plain PyTorch version on the same inputs:
     integers bit for bit, dense f32 at rtol 1e-6. Times each kernel, its
     plain version and, where one PyTorch call does comparable work, that
     call (CUDA events, warmed up), beside the least time the card could
     take (bytes over 3.35 TB/s, or operations over 67 T/s), and an empty
     kernel's device time (the launch floor). fused_genvocab and
     fused_genvocab_slabs are also timed on fresh states (every slot
     NEVER), fused_genvocab on the binary feed's first chunk (every row
     live, its own bound), dense_transform on f32 input too; the embedding
     gradient's record shows its zeroing, sort and sum apart (one
     torch.profiler pass).
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
  4b. sharded — the sharded engines at CRITEO and CRITEO_1M, every shard on
     the one card: the row-parallel ShardedPiperPipeline at 1, 2, 4 and 8
     shards on the utf8 decoded, utf8 bytes-in, binary (the first 2^20
     rows of the main phase's table) and counts routes, and the crossed
     plan at 4 shards at 5K, each held with torch.equal to the
     single-device PiperPipeline on the same chunk sequence (run_scan and
     transform_scan outputs, padding rows included; build_vocab_scan; the
     merged state, counts included); the column-parallel ShardedPiper on
     ('data', 'model') 2x4 and ('pod', 'data', 'model') 2x2x2, held on the
     valid rows and the first 26 columns, with every padding column 0 and
     the vocabulary's first 26 rows equal to the single-device table; its
     genvocab and apply_vocab blocks against their plain versions. Every
     launch count is exact (one loop-① and one loop-② kernel per chunk and
     shard, pad chunks included, plus decode; per ShardedPiper step and
     position one decode a loop, one genvocab, one apply_vocab, one
     dense_transform). Prints wall seconds and rows/s of each loop per shard
     count, the merge tree's device ms at 8 shards beside its bound, and
     ShardedPiper's finalize ms.
  5. train — Piper → DLRM training at CONFIG_5K and CONFIG_1M (full width,
     batches of 4096 rows, AdamW with global-norm clipping, TF32 off):
     run_stream over the utf8 feed with the default hints, its valid rows
     through input_pipeline.stream_batches, then 50 (5K) or 20 (1M) train steps with
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
  7. stream — the streaming preprocessing service (repro_torch.stream) at
     CRITEO and CRITEO_1M, on the utf8 decoded route, the bytes-in route
     and the binary feed, with the default buckets (1024, 4096, 16384
     rows) over the first 2^18 rows of each feed. The vocabulary comes from
     loop ① over the first half; the service warms every bucket, then
     serves the second half as seeded requests of 1-511 rows plus one of
     20000 rows that must split, each held to the offline
     FrozenVocabTransform table of the same rows (integers bit for bit,
     dense at rtol 1e-6). Each micro-batch must launch exactly its route's
     kernels (counted, and seen by the profiler), and
     stream.recompiles_total must equal the bucket count after warm-up,
     after the pass and after a swap. A second thread absorbs a
     16384-row payload: the merged VocabState must equal offline loop ①
     over the same rows in order, and a second pass is served under the
     new vocabulary (on the utf8 route also with the count plane, through
     fused_genvocab_slabs). A service with a ChunkCache serves the payloads
     twice; the second pass must hit on every request, with identical
     outputs. Prints rows/s, p50/p95/p99 ms, the stall split, the overlap
     counter, the device's busy share of a profiled window, device ms of
     each route's kernels and copies at each bucket, and the swap's and
     the vocab digest's seconds.
  8. e2e — Piper → DLRM training fed by the streaming service, through
     launch/train_dlrm_e2e's functions (prepare, start_service, train):
     loop ① offline over the train phase's utf8 feed, then a service with
     one bucket of 4096 rows serving payloads of 4096 consecutive rows to
     TrainInputPipeline, 50 (5K) or 20 (1M) train steps at full width. At
     5K four runs: overlap off, overlap on, overlap on with a fresh
     ChunkCache, overlap off on the same cache, now warm; at 1M the first
     two. All runs of a range must end in the same parameters, bit for bit
     (torch.equal on the card), and at 5K also those of the same steps fed
     by run_stream (and the train phase's, when it ran); the warm run must
     dispatch no micro-batch and launch no decode_scan; every batch must be
     on the card; each run must launch one decode_scan and one
     fused_transform per service batch and one embedding_gather and its
     gradient per step. The engine on the card must equal the row-wise CPU
     baseline (core/baseline.py) over the first 2^13 rows of the utf8 feed
     and of the binary table. Prints per run ms per step, rows/s, the e2e
     and the service's stall splits, cache hits and misses and launches
     per step by kernel; the H2D staging time per batch; the baseline's
     seconds.
  9. lm_train — gemma-2b trained from Piper's tokens (launch/train.py's
     functions, train/trainer.py's Trainer; bf16 compute, TF32 off).
     preprocess_tokens over 2^16 synth rows on the card must launch one
     fused_genvocab and one fused_transform per chunk and one decode_scan
     per chunk in each loop, and equal the CPU path's tokens bit for bit.
     gemma-2b SMOKE trains 3 steps on the card and on the CPU from the
     same step-0 checkpoint and batches (losses, grad norms and weights
     held to LM_SMOKE_TOL). Then CONFIG (18 layers, d 2048, vocab 256000)
     with remat and the chunked route trains 6 steps of train_4k's
     sequence (4096) at a global batch of 4 in 2 microbatches: finite
     losses, no kernel of the port launched by a train step, ms per step
     (CUDA events), tokens/s, the model-FLOPs share, busy share, device
     launches per step, peak memory, the largest device costs of one
     profiled step (products, the chunked attention's f32 einsums, the CE
     blocks timed apart, clipping and AdamW) and the final checkpoint's
     bytes and seconds (~30 GB under build/, restored bit for bit, then
     deleted). Last, at full width cut to 2 layers, 4 steps uninterrupted
     against 2 steps, a checkpoint, a new Trainer and 2 more: the weights
     and AdamW state must be equal bit for bit.

  9b. zoo — the MoE, SSM and hybrid families (bf16 compute, TF32 off).
     The flash kernel at qwen2-moe's and hymba's prefill shapes (4 x 4096;
     16/16 heads at D 128, 25/5 heads at D 64) against ref.mha one query
     head at a time, timed beside SDPA as in the serve phase. SMOKE of
     qwen2-moe-a2.7b, kimi-k2-1t-a32b, hymba-1.5b and xlstm-350m on the
     card (flash route) against the CPU path (chunked), float32: a forward
     and 8 decode steps within 1e-4 of the largest logit. Then qwen2-moe
     (14.3 G parameters, 57 GB of f32 weights), hymba-1.5b and xlstm-350m
     at their published width and depth, one at a time, random weights
     from a seeded generator. A 4 x 4096 prefill of Piper's tokens through
     attn_impl="flash" must launch flash_attention exactly once per layer
     without a window (24, 4, 0). It is held to the chunked route: the
     first layer's update on the same input in bf16 and, for MoE, the
     whole model made to take the flash run's routing, within 5e-2
     relative L2; the whole model in float32 within 1e-3. The free-running
     bf16 logits' gap (qwen2-moe's routing flips and drops, hymba's
     rms-normalised Mamba outputs amplify rounding) and, for qwen2-moe,
     the share of routing choices the routes agree on are printed.
     ServeEngine serves ENGINE's traffic: the first request of each wave
     at its last prompt position against the prefill step, gated at 5e-2
     for xlstm and printed for the others; 4 prompts decoded together in
     float32 (qwen2-moe at a capacity that drops nothing, on either side)
     must agree with the first one's prefill within 1e-3. hymba decodes a
     1088-token prompt through its first superblock (8 layers, the phase's
     time; every 1024-slot ring wraps) in bf16 and float32 against the
     chunked prefill (5e-2, 1e-3). hymba and xlstm step a LONG_500K state
     (batch 1, 524288 positions) 4 times. Prints per model ms per prefill,
     tokens/s, busy share, launches, peak memory, ms per decode step and
     the engine's tokens/s, with the card's name and power limit.
  9c. cross — cross-attention (bf16 compute, TF32 off). The flash kernel
     at llama-3.2-vision-90b's self-attention (4 x 4096, 64 query heads over
     8 kv heads, D 128, causal) and cross-attention shapes (4096 queries
     over 1024 keys, not causal, k/v as strided head views) and at
     whisper-small's decoder self-attention (16 x 256, 12 heads, D 64)
     against ref.mha one query head at a time, timed beside SDPA as in the
     serve phase. SMOKE of both models on the card (flash route) against
     the CPU path (chunked), float32, with their stub inputs (frames,
     patches: normal x 0.1): a forward and 8 decode steps after
     fill_context_caches within 1e-4 of the largest logit; one train step
     (bf16, the chunked route, 2 microbatches) within the lm_train phase's
     SMOKE bounds. Then llama-3.2-vision-90b at full width cut to 2
     superblocks (10 layers: 8 self-attention, 2 cross; 10.7 G parameters,
     42.6 GB of f32 weights) and whisper-small at full width and depth. A
     prefill (4 x 4096 tokens with 4 x 1024 patches; 16 x 256 tokens with 16
     x 1500 frames) through attn_impl="flash" must launch flash_attention
     exactly 10 and 12 times (whisper's 1500-frame encoder and cross layers
     take the chunked route: 1500 is not a multiple of 128) and nothing
     else hand-written; timed (median of 2), profiled, and held to the
     chunked route: the first layer of each kind the kernel takes, bf16,
     within 5e-2 relative L2, and the first prompt through the whole model
     in float32 within 1e-3. Then 4 prompts of 32 tokens decoded in float32
     after fill_context_caches must agree with the first one's float32
     prefill within 1e-3, and a bf16 decode is timed. Prints per model ms
     per prefill, tokens/s, busy share, launches, ms per decode step and
     the peak memory, with the card's name and power limit.
  9d. sharded_train — qwen2-moe-a2.7b over mesh (2, 4) of ("data", "model"),
     every position on the one card (bf16 compute, TF32 off). (a) A prefill
     of 4 x 4096 Piper tokens at full width and depth under use_mesh: every
     MoE layer takes the expert-parallel path (15 experts a rank); it must
     launch flash_attention exactly 24 times; timed, profiled, with the
     capacity drops per layer beside the dense route's; its first 2 layers
     in float32 equal the dense path run per data shard within 1e-5
     relative L2 (auxiliary loss 1e-6), with drops present. (b)
     Trainer(mesh, param_shardings) at full width cut to 2 layers, 3 steps
     of 4 x 4096 tokens under use_mesh, against the unsharded Trainer under
     the same use_mesh from the same seeded init and batches (LM_SMOKE_TOL);
     its peak memory at most 1.1 x the unsharded run's. (c)
     compressed_psum_mean over (b)'s two data shards' first-step gradients:
     within scale / 2 of the plain mean, the residual exact, the payload's
     bytes against float32's. (d) qwen2-moe SMOKE at 2 layers: a
     checkpoint written under (2, 4) (two steps, no use_mesh); Trainers on
     (4, 2) and with no mesh resume it: each restored state equal to the
     writer's bit for bit, the first resumed loss equal bit for bit, the
     two continuations within LM_SMOKE_TOL. Prints ms, tokens/s, busy
     share, peaks and ms per step, with the card's name and power limit.
  10. analysis — the port's static gate (python -m repro_torch.analysis
     --strict) in-process on the card: planlint, kernelcheck (the shape
     matrix's routes and launches on the card, the CUDA source audit, every
     library's launch_accounting against its <library>_launch_config, the
     ptxas logs), the launch audit (JX301 under sync debug mode "error",
     the fused-reduction property, in-place train steps) and locklint; any
     new finding fails the run. Then each audited route at CRITEO (fused
     with bytes-in, the count plane, use_kernels on the decoded route,
     4096 rows, bytes-in at max_rows 16384) once under the
     launch audit: each call's kernel entries must equal its launch
     counters and the hand-written kernels the profiler sees on the card,
     exactly. Prints the ptxas table (registers, shared bytes, spills per
     kernel) and the phase's seconds.

The last lines are the {"kernels": [...]} summary, the nvidia-smi name
and power limit, and {"ok": true, "device": {...}}. Without a CUDA device,
or without the repository's src/ beside this file, it exits non-zero and
prints no result. --rehearse runs the same phases on the CPU at a tiny
size, where every wrapper takes its plain version: it checks the script,
times nothing and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
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
# The stream phase's path: loop ② on the decoded, bytes-in and binary
# routes, and absorb's loop ① (with the count plane on the utf8 route).
STREAM_KERNELS = ("decode_scan", "fused_transform", "fused_decode_transform", "fused_genvocab",
                  "fused_genvocab_slabs", "fused_decode_genvocab")
# The sharded phase: the row-parallel ShardedPiperPipeline at each shard
# count on every route below (and the crossed plan at one count, at 5K),
# the column-parallel ShardedPiper on each mesh below, at both vocab
# ranges, over the main phase's utf8 feed and the first SHARDED_BINARY_ROWS
# rows of its binary table. Every shard runs on the one card.
SHARD_COUNTS = (1, 2, 4, 8)
# route → (feed, config fields, the kernels each chunk launches in loop ①,
# in loop ②), decode included
SHARDED_ROUTES = {
    "utf8": ("utf8", {}, ("decode_scan", "fused_genvocab"), ("decode_scan", "fused_transform")),
    "utf8_bytes_in": ("utf8", {"use_fused_decode": True}, ("fused_decode_genvocab",),
                      ("fused_decode_transform",)),
    "binary": ("binary", {}, ("fused_genvocab",), ("fused_transform",)),
    "utf8_counts": ("utf8", {"track_vocab_counts": True},
                    ("decode_scan", "fused_genvocab_slabs"), ("decode_scan", "fused_transform")),
}
SHARDED_CROSSED = ("crossed_utf8_fused", 4, "5K")  # route, shards, range
SHARDED_BINARY_ROWS = 1 << 20
# A rehearsal's feeds: utf8 rows, binary rows, chunk bytes, rows a chunk.
SHARDED_REHEARSAL = (800, 2000, 1 << 15, 256)
COLUMN_MESHES = {"2x4": ((2, 4), ("data", "model")),
                 "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHARDED_NOTE = ("every shard runs on the one card, one after another on one stream: rows/s "
                "across shard counts is not a scaling result")
# The sharded phase's path: both engines' kernels.
SHARDED_KERNELS = ("decode_scan", "fused_genvocab", "fused_genvocab_slabs", "fused_transform",
                   "fused_decode_genvocab", "fused_decode_transform", "genvocab", "apply_vocab",
                   "dense_transform")
# The stream phase: the service's default buckets over the first 2^18 rows
# of each feed (the vocabulary from the first half, requests over the
# second), request sizes of 1..STREAM_MAX_REQUEST rows from a seeded
# generator (the reference demo's), one request of STREAM_SPLIT_ROWS that
# must split, and one absorbed payload of the largest bucket's rows. A
# rehearsal runs smaller buckets over the rehearsal rows.
STREAM_ROWS = 1 << 18
STREAM_BUCKETS = (1024, 4096, 16384)
REHEARSAL_STREAM_BUCKETS = (64, 256, 1024)
STREAM_MAX_REQUEST = 511
STREAM_SPLIT_ROWS = {"card": 20000, "rehearsal": 1500}
# stream route → (feed, config fields, the kernels each micro-batch launches)
STREAM_ROUTES = {
    "utf8": ("utf8", {}, ("decode_scan", "fused_transform")),
    "utf8_bytes_in": ("utf8", {"use_fused_decode": True}, ("fused_decode_transform",)),
    "binary": ("binary", {}, ("fused_transform",)),
}
STREAM_WAIT_S = 300  # the bound on every wait of the stream phase
# The e2e phase: Piper → DLRM training fed by the streaming service over the
# train phase's utf8 feed, payloads (and the one bucket) of TRAIN_BATCH rows,
# TRAIN_STEPS steps (so the train phase's weights compare); runs per range as (name, overlap, chunk cache: None, "fresh" or "warm").
E2E_RUNS = {"5K": (("a_overlap_off", False, None), ("b_overlap_on", True, None),
                   ("c_overlap_on_cold_cache", True, "fresh"),
                   ("d_overlap_off_warm_cache", False, "warm")),
            "1M": (("a_overlap_off", False, None), ("b_overlap_on", True, None))}
E2E_CACHE_BYTES = 256 << 20
E2E_WARMUP_STEPS = 5  # an unrecorded pass before the runs of a range
E2E_WAIT_S = 300  # the bound on every drain of the e2e phase
# The e2e path's kernels: loop ① offline, loop ② in the service, the DLRM
E2E_KERNELS = ("decode_scan", "fused_genvocab", "fused_transform", "embedding_gather",
               "embedding_gather_backward")
# The oracle check: the engine on the card against the row-wise CPU
# baseline over the first rows of the utf8 feed and of the binary table.
ORACLE_ROWS = {"card": 1 << 13, "rehearsal": 500}
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
# The lm_train phase: synth rows through launch/train.py's preprocess_tokens
# (2^16 rows make 1.7 M tokens, so no window of a run wraps), the full-width
# cell (train_4k's sequence, its global batch of 256 cut to 4 in 2
# microbatches of 2 to fit one card and the phase's time, 6 steps) and the
# resume contract's depth and steps. A rehearsal runs gemma-2b SMOKE at
# shorter sequences.
LM_TRAIN_ROWS = {"card": 1 << 16, "rehearsal": 1500}
LM_TRAIN = {"card": {"batch": 4, "seq": 4096, "microbatches": 2, "steps": 6},
            "rehearsal": {"batch": 4, "seq": 256, "microbatches": 2, "steps": 3}}
LM_SMOKE_RUN = {"batch": 4, "seq": 256, "microbatches": 2, "steps": 3}
LM_RESUME = {"layers": 2, "steps": 4}
LM_LR = 3e-4
# The lm_train path's kernels: Piper's decoded route in preprocess_tokens
# (the train steps run the chunked route, which has no kernel).
LM_TRAIN_KERNELS = ("decode_scan", "fused_genvocab", "fused_transform")
# The zoo phase: the MoE, SSM and hybrid families at their published width
# and depth (random weights from a seeded generator, f32 at rest, bf16
# compute, TF32 off), one model at a time. Each prefills ZOO_PREFILL on the
# flash route and serves ENGINE's traffic; hymba also decodes one prompt of
# ZOO_RING_PROMPT tokens (past its 1024-token windows, so every ring wraps)
# and, with xlstm, steps a LONG_500K state. A rehearsal runs the SMOKE
# configs at ZOO_REHEARSAL's sizes (SMOKE windows are 32).
ZOO_MODELS = {"qwen2-moe-a2.7b": "qwen2-moe", "hymba-1.5b": "hymba", "xlstm-350m": "xlstm"}
ZOO_SMOKES = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m")
ZOO_PREFILL = (4, 4096)
ZOO_RING_PROMPT = 1088
ZOO_LONG_STEPS = 4  # decode steps at the last positions of LONG_500K's sequence
ZOO_REHEARSAL = {"prefill": (2, 128), "ring_prompt": 48}
ZOO_SMOKE_RUN = {"batch": 2, "seq": 64, "decode_steps": 8}
# SMOKE on the card against the CPU path, float32 compute, TF32 off: the
# logits within 1e-4 of their largest value (summation order only; the bound
# of tests/test_torch_cuda.py::test_lm_smoke_prefill_on_card_matches_cpu).
ZOO_SMOKE_REL = 1e-4
# Two float32 routes (the flash kernel's f32 route against the chunked
# route, MoE with the same routing), relative L2 of the logits: float32
# rounds at 2^-24, so even a model that magnifies rounding 10^4-fold stays
# far below this, and a wrong mask or cache slot does not.
ZOO_F32_REL_L2 = 1e-3
# The zoo path's kernel: the flash prefill of every layer without a window.
ZOO_KERNELS = ("flash_attention",)
# The cross phase: the vision LM and the encoder-decoder at full width, one
# at a time (random weights from a seeded generator, f32 at rest, bf16
# compute, TF32 off; stub patches and frames, normal · 0.1, as the
# reference's launcher makes them). llama-3.2-vision-90b is cut from 20
# superblocks to 2 (8 self-attention and 2 cross layers): its 87.7 G
# parameters take 351 GB in float32, one card holds 80 GB, and 2
# superblocks take 42.6 GB. whisper-small runs at full depth. Each prefills
# CROSS_PREFILL (batch, tokens) on the flash route, which must launch the
# kernel CROSS_FLASH_LAUNCHES times (llama: every layer; whisper: the 12
# decoder self-attention layers; its 1500-frame encoder and cross layers are
# not a multiple of the kernel's 128-row tiles and take the chunked route),
# then decodes CROSS_DECODE's prompts after fill_context_caches. A rehearsal
# runs the SMOKE configs at CROSS_REHEARSAL's sizes.
CROSS_MODELS = {"llama-3.2-vision-90b": "llama-vision", "whisper-small": "whisper"}
CROSS_SUPERBLOCKS = {"llama-3.2-vision-90b": 2}
CROSS_PREFILL = {"llama-3.2-vision-90b": (4, 4096), "whisper-small": (16, 256)}
CROSS_FLASH_LAUNCHES = {"llama-3.2-vision-90b": 10, "whisper-small": 12}
CROSS_DECODE = {"prompts": 4, "prompt_len": 32}
CROSS_REHEARSAL = {"prefill": (2, 128)}
CROSS_KERNELS = ("flash_attention",)
# The sharded_train phase: qwen2-moe-a2.7b over mesh SHARDED_TRAIN_MESH, every
# position on the one card (NCCL refuses two ranks on one device, so a mesh
# over cards is not exercised). (a) a prefill of SHARDED_TRAIN["prefill"]
# Piper tokens at full width and depth under use_mesh: every MoE layer on the
# expert-parallel path (60 experts, 15 a rank), bf16; its first
# SHARDED_TRAIN_LAYERS layers in float32 against the dense path run per data
# shard. (b) Trainer(mesh, shardings) at full width cut to
# SHARDED_TRAIN_LAYERS layers, SHARDED_TRAIN["steps"] steps under use_mesh,
# against the unsharded Trainer under the same use_mesh (LM_SMOKE_TOL), its
# peak memory within SHARDED_TRAIN_PEAK of the unsharded run's. (c)
# compressed_psum_mean over (b)'s two data shards' first-step gradients.
# (d) at SMOKE width (the published capacity) and SHARDED_TRAIN_LAYERS
# layers, a checkpoint written under SHARDED_TRAIN_MESH resumed under
# SHARDED_TRAIN_RESUME_MESH and with no mesh (MoE's dense path, no use_mesh:
# both continuations then start from one state and batch); the round trip of
# a full-width state's checkpoint is the lm_train phase's. A rehearsal runs
# SMOKE at SHARDED_TRAIN_REHEARSAL's sizes.
SHARDED_TRAIN_ARCH = "qwen2-moe-a2.7b"
SHARDED_TRAIN_MESH = ((2, 4), ("data", "model"))
SHARDED_TRAIN_RESUME_MESH = ((4, 2), ("data", "model"))
SHARDED_TRAIN_LAYERS = 2
SHARDED_TRAIN = {"prefill": (4, 4096), "batch": 4, "seq": 4096, "steps": 3,
                 "resume_at": 2, "resume_steps": 4}
# A rehearsal trains one step in (b): at SMOKE's few elements a leaf, the
# CPU's bf16 rounding (other at each batch split) flips AdamW's near-sign
# update on more than LM_SMOKE_TOL's share of some leaf's elements after it.
SHARDED_TRAIN_REHEARSAL = {"prefill": (4, 128), "batch": 4, "seq": 64, "steps": 1,
                           "resume_at": 2, "resume_steps": 4}
SHARDED_TRAIN_NOTE = ("every mesh position runs on the one card, one after another: times "
                      "are of the one-card layout, not of a mesh over cards")
SHARDED_TRAIN_PEAK = 1.10  # the sharded Trainer's peak against the unsharded one's
# (a)'s float32 check, the EP path against the dense path per data shard:
# relative L2 of the hidden states (only the order of float32 sums differs)
# and the auxiliary loss, relative
SHARDED_EP_F32_REL_L2 = 1e-5
SHARDED_EP_AUX_REL = 1e-6
# The sharded_train path's kernel: the flash prefill of (a)'s 24 layers.
SHARDED_TRAIN_KERNELS = ("flash_attention",)
# The kernels the analysis phase's audited routes launch at CRITEO: the fused
# and bytes-in routes, the count plane, the use_kernels chain, and decode.
ANALYSIS_KERNELS = ("decode_scan", "fused_genvocab", "fused_genvocab_slabs", "fused_transform",
                    "fused_decode_genvocab", "fused_decode_transform", "genvocab",
                    "apply_vocab", "dense_transform")
# gemma-2b SMOKE, 3 steps from the same weights and batches, the card
# against the CPU (bf16 compute, TF32 off): each step's loss and grad norm
# within rtol 1e-3 (bf16 rounds at other points on the two devices; on an
# H100 at most 5.2e-6 and 2.0e-4); at most 2% of a leaf's elements more
# than lr apart (on an H100 at most 0.20%). That fraction is the weight
# check: AdamW's step is about lr·sign(g), so two runs' weights differ by
# about 0 or 2·lr an element and step, and a gradient within rounding of 0
# may take the other sign. A bound on the largest gap, steps·2·lr, could
# not fail; the largest gap is printed (on an H100 6.2e-4).
LM_SMOKE_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 1e-3, "flip_frac": 0.02}
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
# mangled name in ptxas's log; it must build without spills. The D 128
# (qwen2-moe's) and D 64 (hymba's) instantiations are reported beside it.
FLASH_WGMMA_D256 = "flash_wgmma_kernelILi256E"
FLASH_WGMMA_OTHERS = {"flash_wgmma_d128": "flash_wgmma_kernelILi128E",
                      "flash_wgmma_d64": "flash_wgmma_kernelILi64E"}


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


def traced_kernels(torch, fn, calls: int) -> list:
    """The device events (kernels and copies, by name) of one torch.profiler
    trace over ``calls`` calls of ``fn``, recorded after a warm-up round of
    ``calls`` calls that the profiler traces and drops (a trace may miss the
    first launches after it starts)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_kernels(torch, fn, calls: int = 5, traces: int = 6) -> dict:
    """Device kernels and copies by name over ``calls`` calls of ``fn``:
    the largest count each name reached in one of up to ``traces`` traces
    of :func:`traced_kernels`. A trace now and then drops events (never
    adds one), so the traces stop only once every name's count is a whole
    multiple of ``calls``: one name complete says nothing of another's
    (a decode call's trace held its 5 decodes and 4 of its 5 vocab
    updates)."""
    found = {}
    for _ in range(traces):
        for e in traced_kernels(torch, fn, calls):
            found[e.key] = max(found.get(e.key, 0), e.count)
        if found and all(n % calls == 0 for n in found.values()):
            break
    return found


_HEX = "0123456789abcdef"
HOSTILE_KINDS = ("normal", "empty_fields", "all_delim", "invalid_hex", "overlong_hex",
                 "overlong_decimal", "weird_minus", "long_straddle")


def hostile_rows(np, seed: int, n_dense: int, n_sparse: int, n_rows: int,
                 truncate: int) -> bytes:
    """Rows of every hostile class: empty fields and all-delimiter rows,
    invalid and overlong hex, overlong decimals, stray minus signs, and
    4136-byte fields, longer than the Pallas kernels' 4 KiB tiles and than
    the card kernels' 256-byte halo. ``truncate`` cuts that many bytes (the
    newline first) off the final row."""
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


def _rows_up_to(np, rng, length: int, fields: int = CRITEO_FIELDS) -> bytes:
    """Rows of ``fields`` fields, as many as fit in ``length`` bytes."""
    out = b""
    while True:
        row = _row(np, rng, fields)
        if len(out) + len(row) > length:
            return out
        out += row


def decode_edge_chunks(np) -> list:
    """(name, uint8 array, max_rows) of the decode kernels' edge cases,
    Criteo rows, for tiles of 4, 8 or 16 KiB: empty and one-byte chunks, a
    length no multiple of 16, a field longer than two 16 KiB tiles, a field
    longer than the 256-byte halo across the 8 KiB tile boundary, rows a
    field too long or short, a truncated final row, more delimiters than
    cells, an all-padding chunk, and data that ends on a tile boundary and
    one byte past it (8193 bytes). And rows over four 8 KiB tiles that the
    tiles cannot count from their own newlines (fused_decode_vocab.cu
    holds their cells back): rows three fields long (the flat rows run
    ahead of the newlines), max_rows cutting a tile, rows two fields short
    (the cells past the last delimiter lie in rows below #newlines) with
    the final row truncated."""
    rng = np.random.default_rng(7)
    whole = b"".join(_row(np, rng) for _ in range(200))
    long_field = b"".join(_row(np, rng, field_len=2 * 16384 + 700 if i == 3 else 0)
                          for i in range(12))
    widths = b"".join(_row(np, rng, CRITEO_FIELDS + (i % 3 == 1) - (i % 3 == 2))
                      for i in range(60))
    # a field longer than the 256-byte halo that begins 570-ish bytes before
    # byte 8192 and ends 300 bytes after it: across the 8 KiB tile boundary
    head = b""
    while len(head) + 900 <= 8192:
        head += _row(np, rng)
    row = _row(np, rng)
    row = row[: row.rindex(b"\t") + 1]
    field = "".join(rng.choice(list(_HEX), size=8192 + 300 - len(head) - len(row))).encode()
    over_halo = head + row + field + b"\n" + b"".join(_row(np, rng) for _ in range(5))
    out = [("empty", b"", 64), ("one_byte", b"\n", 64), ("n_4097", whole[:4097], 64),
           ("field_over_halo_across_8192", over_halo, 64),
           ("long_field_over_two_tiles", long_field, 64),
           ("field_widths_off_by_one", widths, 64), ("truncated_row", whole[:-9], 256),
           ("more_delims_than_cells", whole, 37), ("all_padding", bytes(3 * 16384 + 5), 64)]
    for length in (8192, 16384):
        ends = _exact_rows(np, rng, length)
        out += [(f"ends_on_{length}", ends, 256), (f"ends_one_byte_past_{length}", ends + b"7", 256)]
    tiles4 = 4 * 8192 - 100
    whole4 = _rows_up_to(np, rng, tiles4)
    cut = whole4.count(b"\n", 0, 2 * 8192 + 4000)  # row `cut` ends inside the third tile
    out += [("long_rows_over_4_tiles", _rows_up_to(np, rng, tiles4, CRITEO_FIELDS + 3), 256),
            ("max_rows_inside_a_tile", whole4, cut),
            ("short_rows_over_4_tiles", _rows_up_to(np, rng, tiles4, CRITEO_FIELDS - 2)[:-5], 256)]
    return [(name, np.frombuffer(raw, np.uint8).copy(), mr) for name, raw, mr in out]


class Smoke:
    """The phases, on the card, or on the CPU for a rehearsal."""

    def __init__(self, torch, np, rehearse: bool):
        self.torch, self.np = torch, np
        self.rehearse = rehearse
        self.dev = torch.device("cpu" if rehearse else "cuda")
        self.floor_ms = None  # the launch floor, once the kernels phase measured it
        self.smi = "cpu rehearsal: no card"  # nvidia-smi's name and power limit
        self.train_params = {}  # range → the train phase's final parameters (5K)

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
        name, from one short trace over ``reps`` calls (short, so the trace
        keeps every launch; :func:`traced_kernels`); None in a rehearsal."""
        if self.rehearse:
            fn()
            return None
        found = {}  # names cut to 60 characters; kernels whose names agree that far add up
        for e in traced_kernels(self.torch, fn, reps):
            if e.self_device_time_total:
                v = found.setdefault(e.key[:60], {"count": 0, "ms": 0.0})
                v["count"] += e.count
                v["ms"] += e.self_device_time_total / 1e3 / reps
        return found

    def kernels_per_call(self, fn, reps: int = 5) -> dict | None:
        """Device kernels and copies of one call of ``fn`` by name
        (:func:`device_kernels` over ``reps`` calls, over ``reps``); None
        in a rehearsal."""
        if self.rehearse:
            fn()
            return None
        found = {}  # names cut to 60 characters; kernels whose names agree that far add up
        for name, n in device_kernels(self.torch, fn, reps).items():
            found[name[:60]] = found.get(name[:60], 0) + n / reps
        return found

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

        self.floor_ms = self.each_ms([launch] * 50)
        return self.floor_ms

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

    def profile(self, fn, ops: bool = False):
        """The device's kernels and copies during one call of ``fn``
        (torch.profiler), by name: ``{"name", "count", "ms"}``, most device
        time first. None in a rehearsal.

        With ``ops`` the host is recorded too, and the result is ``(kernels,
        host)``: ``host`` holds the ops and the port's obs spans (entered
        while the process tracer is on) that launched device work, each
        with the device ms of the kernels it launched itself (``ms``) and
        with its children's (``total_ms``), most ``ms`` first. ``(None,
        None)`` in a rehearsal. A span's range on the device is not a
        kernel and is left out of ``kernels``."""
        if self.rehearse:
            fn()
            return (None, None) if ops else None
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ops else [])
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        kernels, host = [], []
        for e in prof.key_averages():
            if e.device_type == cuda:
                if e.self_device_time_total and not getattr(e, "is_user_annotation", False):
                    kernels.append({"name": e.key[:80], "count": e.count,
                                    "ms": e.self_device_time_total / 1e3})
            elif e.device_time_total:
                host.append({"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3,
                             "total_ms": e.device_time_total / 1e3})
        kernels.sort(key=lambda r: -r["ms"])
        if not ops:
            return kernels
        return kernels, sorted(host, key=lambda r: (-r["ms"], -r["total_ms"]))

    @contextlib.contextmanager
    def tracing(self):
        """The port's process tracer on for the block (its spans recorded,
        and entered in torch.profiler while that records), then as it was.
        Yields the tracer."""
        from repro_torch import obs

        was_on = obs.enabled()
        obs.enable()
        try:
            yield obs.tracer()
        finally:
            if not was_on:
                obs.disable()

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
        self.smi = smi
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
        others = {k: ptxas_usage(logs["flash_attention"], entry)
                  for k, entry in FLASH_WGMMA_OTHERS.items()}
        emit({"phase": "build", "seconds": seconds,
              "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()},
              "ptxas": ptxas, "flash_wgmma_d256": flash, **others})
        info.update(others)
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

        # the launch floor: an empty kernel's device time on the same stream,
        # recorded beside every kernel's time
        floor_ms = self.launch_floor()
        emit({"phase": "kernels", "launch_floor_ms": floor_ms,
              "what": "device time of an empty kernel (fused_vocab.cu::empty_kernel)"})

        def record(name, rec):
            records[name] = rec = {**rec, "launch_floor_ms": floor_ms}
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
                per_call = self.kernels_per_call(lambda: fvops.fused_update(st, sparse, valid))
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
                    "kernels_per_call": per_call,
                }
                expect(per_call is None or list(per_call.values()) == [1],
                       f"{name} V={vr}: device work per call {per_call}, expected one kernel")
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
                record(f"{name}@{tag}", rec)

            # the bytes-in loops ① and ②: the 1 MiB chunk, the hostile
            # chunks and the edge chunks, into that state (at its own offset
            # and three rows below the ceiling) and through that vocabulary
            fkw = dict(n_fields=sch.n_fields, hex_start=1 + sch.n_dense)
            err = 0.0
            edge = [(torch.from_numpy(arr).to(dev), max_rows, f"edge chunk {name}")
                    for name, arr, max_rows in decode_edge_chunks(np)]
            for b, max_rows, what in byte_chunks + edge:
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
                err = max(err, self._xform_same(got, want,
                                                f"fused_decode_transform V={vr}, {what}"))
            st = vocab_lib.VocabState(base.first_pos.clone(), base.rows_seen.clone())
            n = buf.numel()
            # the chunk in, rows_seen in and out, each state slot that the
            # decoded chunk above touched read and written once
            b_ms, b_by = bound(n + 8 + state_touched * 8, 12 * n + 4 * rows * n_cols)
            per_call = self.kernels_per_call(
                lambda: fdvops.fused_decode_update(st, buf, max_rows=MAX_ROWS, **fkw))
            record(f"fused_decode_genvocab@{tag}", {
                "max_abs_err": 0,
                **self.times(
                    lambda: fdvops.fused_decode_update(st, buf, max_rows=MAX_ROWS, **fkw),
                    lambda: fdvref.fused_decode_genvocab(st, buf, max_rows=MAX_ROWS, **fkw),
                    plain_reps=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"{n} B chunk, max_rows {MAX_ROWS}, into [{n_cols}, {vr}]",
                "cuda_launches_per_call": (None if per_call is None
                                           else sum(per_call.values())),
                "kernels_per_call": per_call,
            })
            expect(per_call is None or list(per_call.values()) == [1],
                   f"fused_decode_genvocab V={vr}: device work per call {per_call}, "
                   "expected one kernel")
            # the chunk in, each touched table slot read once, the label,
            # dense, ids and valid outputs written once
            out_bytes = MAX_ROWS * (4 + 4 * n_dense + 4 * n_cols + 1)
            b_ms, b_by = bound(n + touched * 4 + out_bytes,
                               12 * n + rows * (3 * n_cols + 20 * n_dense))
            err = max(err, self.decode_xform_checks(data, vocab, fdxops, fdxref, dops, tag))
            per_call = self.kernels_per_call(
                lambda: fdxops.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw))
            record(f"fused_decode_transform@{tag}", {
                "max_abs_err": err,
                **self.times(
                    lambda: fdxops.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw),
                    lambda: fdxref.fused_decode_transform(vocab, buf, max_rows=MAX_ROWS, **fkw),
                    plain_reps=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"{n} B chunk, max_rows {MAX_ROWS}, table [{n_cols}, {vr}]",
                "cuda_launches_per_call": (None if per_call is None
                                           else sum(per_call.values())),
                "kernels_per_call": per_call,
            })
            expect(per_call is None or list(per_call.values()) == [1],
                   f"fused_decode_transform V={vr}: device work per call {per_call}, "
                   "expected one kernel")

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
            self.genvocab_checks(vops, vocab_lib, base27, modded27, valid, tag)
            st = vocab_lib.VocabState(base27.first_pos.clone(), base27.rows_seen.clone())
            pos = vocab_lib.positions(st.rows_seen, rows, valid)
            slots27 = torch.arange(n27, device=dev)[None, :] * vr + modded27
            live = (pos < vocab_lib.NEVER)[:, None].expand(rows, n27)
            touched27 = int(torch.unique(slots27[live]).numel())
            idx_t = mt.to(torch.int64).contiguous()
            src = pos[None, :].expand_as(idx_t).contiguous()
            # valid flags in, the live rows' modded values in (the kernel skips
            # an invalid row before it reads them), rows_seen in and out, each
            # touched state slot read and written once; a compare and a min
            # per live cell
            live_rows = int(live.any(1).sum())
            b_ms, b_by = bound(live_rows * n27 * 4 + rows + 8 + touched27 * 8,
                               2 * live_rows * n27)
            per_call = self.kernels_per_call(lambda: vops.genvocab_update(st, modded27, valid))
            record(f"genvocab@{tag}", {
                "max_abs_err": 0,
                # the whole call, which is one launch; its plain version is
                # vocab.update (positions, scatter-min, rows_seen)
                **self.times(lambda: vops.genvocab_update(st, modded27, valid),
                             lambda: vocab_lib.update(st, modded27, valid),
                             lambda: st.first_pos.scatter_reduce_(1, idx_t, src, reduce="amin")),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_call": "Tensor.scatter_reduce_(amin) on the transposed int64 indices "
                                "and positions made beforehand (it leaves out the positions "
                                "and rows_seen)",
                "shape": f"modded [{rows}, {n27}] into [{n27}, {vr}]",
                "cuda_launches_per_call": (None if per_call is None
                                           else sum(per_call.values())),
                "kernels_per_call": per_call,
            })
            expect(per_call is None or list(per_call.values()) == [1],
                   f"genvocab V={vr}: device work per call {per_call}, expected one kernel")
            vocab27 = vocab_lib.finalize(base27)
            ids_k = vops.apply_vocab(vocab27.table, modded27)
            self.sync()
            expect(torch.equal(ids_k, vref.apply_vocab(vocab27.table, mt).t()),
                   f"apply_vocab V={vr}: ids differ")
            # modded values in, ids out, each touched table slot read once;
            # the 32-byte sectors of 8 slots that hold them are recorded
            # beside it (the card reads sectors from device memory, but at
            # 5K the table sits in L2)
            sectors27 = int(torch.unique(slots27 // 8).numel())
            b_ms, b_by = bound(rows * n27 * 8 + int(torch.unique(slots27).numel()) * 4,
                               2 * rows * n27)
            per_call = self.kernels_per_call(lambda: vops.apply_vocab(vocab27.table, modded27))
            record(f"apply_vocab@{tag}", {
                "max_abs_err": 0,
                **self.times(lambda: vops.apply_vocab(vocab27.table, modded27),
                             lambda: vref.apply_vocab(vocab27.table, mt).t().contiguous(),
                             lambda: torch.gather(vocab27.table, 1, idx_t)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_call": "torch.gather on the transposed int64 indices (the same function)",
                "shape": f"modded [{rows}, {n27}], table [{n27}, {vr}]",
                "table_sectors": sectors27,
                "bound_ms_by_sectors": bound(rows * n27 * 8 + sectors27 * 32, 0)[0],
                "cuda_launches_per_call": (None if per_call is None
                                           else sum(per_call.values())),
                "kernels_per_call": per_call,
            })
            expect(per_call is None or list(per_call.values()) == [1],
                   f"apply_vocab V={vr}: device work per call {per_call}, expected one kernel")
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
        d12f = d12.to(torch.float32)
        per_call = self.kernels_per_call(lambda: dxops.dense_transform(d12))
        f32 = self.times(lambda: dxops.dense_transform(d12f), lambda: dxref.dense_transform(d12f))
        record("dense_transform", {
            "max_abs_err": err,
            **self.times(lambda: dxops.dense_transform(d12), lambda: dxref.dense_transform(d12)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"int32 [{d12.shape[0]}, {d12.shape[1]}]",
            # the same values as f32 (the same bytes, so the same bound)
            "f32": {k: f32[k] for k in ("ms", "plain_ms", "call_ms", "ms_from")},
            "kernels_per_call": per_call,
        })
        expect(per_call is None or list(per_call.values()) == [1],
               f"dense_transform: device work per call {per_call}, expected one kernel")
        return records

    def genvocab_checks(self, vops, vocab_lib, base, modded, valid, tag: str) -> None:
        """genvocab against its plain version (vocab.update), bit for bit on
        first_pos, counts and rows_seen, into ``base``'s history: the
        chunk's own valid rows (a prefix), a valid mask that is no prefix,
        no valid row, and 40 columns (the 27 and 13 more), each at offsets 0
        and NEVER - 3, with and without counts; then chunks on two streams
        at once, each into its own state."""
        torch, np, dev = self.torch, self.np, self.dev
        rows, n_cols = modded.shape
        rng = np.random.default_rng(27)
        scattered = torch.from_numpy(rng.random(rows) < 0.5).to(dev)
        modded40 = torch.cat([modded, modded[:, :13].flip(0)], dim=1).contiguous()
        # (on the CPU the wrapper's host-side ceiling guard raises at NEVER - 3)
        offsets = [0] + ([] if self.rehearse else [vocab_lib.NEVER - 3])

        def fresh(m, track, rows_seen):
            extra = m.shape[1] - n_cols
            return vocab_lib.VocabState(
                torch.cat([base.first_pos, base.first_pos[:extra]]),
                torch.tensor(rows_seen, dtype=torch.int32, device=dev),
                torch.cat([base.counts, base.counts[:extra]]) if track else None)

        for what, m, v in (("the chunk's valid rows", modded, valid),
                           ("no-prefix valid", modded, scattered),
                           ("no valid row", modded, torch.zeros_like(valid)),
                           ("40 columns", modded40, scattered)):
            for track in (False, True):
                for rows_seen in offsets:
                    got = vops.genvocab_update(fresh(m, track, rows_seen), m, v)
                    want = vocab_lib.update(fresh(m, track, rows_seen), m, v)
                    self.sync()
                    where = f"genvocab {tag} {what} counts={track} rows_seen={rows_seen}"
                    for f in ("first_pos", "rows_seen") + (("counts",) if track else ()):
                        expect(torch.equal(getattr(got, f), getattr(want, f)),
                               f"{where}: {f} differs")
        if self.rehearse:
            return
        streams = [torch.cuda.Stream() for _ in range(2)]
        outs = []
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                state = fresh(modded, True, 100 * i)
                for _ in range(3):
                    state = vops.genvocab_update(state, modded, scattered)
                outs.append(state)
        torch.cuda.synchronize()
        for i, got in enumerate(outs):
            want = fresh(modded, True, 100 * i)
            for _ in range(3):
                want = vocab_lib.update(want, modded, scattered)
            for f in ("first_pos", "counts", "rows_seen"):
                expect(torch.equal(getattr(got, f), getattr(want, f)),
                       f"genvocab {tag} on two streams at once: {f} differs on stream {i}")

    def _xform_same(self, got, want, where: str) -> float:
        """Bytes-in loop ②'s outputs against the plain version's: label, ids
        and valid bit for bit, dense at rtol 1e-6. Returns dense's max
        absolute error."""
        torch = self.torch
        self.sync()
        for i, name in ((0, "label"), (2, "ids"), (3, "valid")):
            expect(torch.equal(got[i], want[i]), f"{where}: {name} differs")
        expect(torch.allclose(got[1], want[1], rtol=1e-6, atol=0),
               f"{where}: dense beyond rtol 1e-6")
        return float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0

    def decode_xform_checks(self, data, vocab, fdxops, fdxref, dops, tag: str) -> float:
        """fused_decode_transform against its plain version on the feed's
        first 2 and 4 MiB chunks, its 1 MiB chunk at max_rows 1000 (below its
        rows), and a field longer than the 256-byte halo across the 8 KiB
        tile boundary; then across an epoch wrap of the look-back scratch
        (decode and it in turn), and on two streams at once. Returns dense's
        max absolute error."""
        torch, np, dev = self.torch, self.np, self.dev
        from repro_torch.data import synth
        from repro_torch.kernels import _scratch
        from repro_torch.kernels.decode_utf8 import ref as dref

        fkw = dict(n_fields=CRITEO_FIELDS, hex_start=1 + CRITEO_DENSE)
        hex_t = np.arange(CRITEO_FIELDS) > CRITEO_DENSE
        dkw = dict(n_fields=CRITEO_FIELDS, n_dense=CRITEO_DENSE,
                   n_sparse=CRITEO_FIELDS - 1 - CRITEO_DENSE)
        edge = {name: (arr, mr) for name, arr, mr in decode_edge_chunks(np)}
        cases = [(f"synth {size >> 20} MiB", next(iter(synth.chunk_stream(data["utf8_buf"], size))),
                  MAX_ROWS) for size in (2 << 20, 4 << 20)]
        cases += [("synth 1 MiB at max_rows 1000", data["utf8_chunks"][0], 1000),
                  ("field over the halo across 8192", *edge["field_over_halo_across_8192"])]
        bufs = [(what, torch.from_numpy(arr).to(dev), mr) for what, arr, mr in cases]
        err = 0.0
        for what, b, mr in bufs:
            got = fdxops.fused_decode_transform(vocab, b, max_rows=mr, **fkw)
            want = fdxref.fused_decode_transform(vocab, b, max_rows=mr, **fkw)
            err = max(err, self._xform_same(got, want, f"fused_decode_transform {tag}, {what}"))
        if self.rehearse:
            return err
        wants = [fdxref.fused_decode_transform(vocab, b, max_rows=mr, **fkw) for _, b, mr in bufs]
        # the scratch made above holds the largest chunk: the next call wraps
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch.scan_scratch(dev, stream, 0)
        scratch.epoch = _scratch.EPOCH_LIMIT - 1
        for i in range(4):
            what, b, mr = bufs[i % len(bufs)]
            where = f"{tag} across the epoch wrap, {what}"
            if i % 2:
                got = dops.decode(b, hex_t, max_rows=mr, **dkw)
                want = dref.decode_bytes(b, hex_t, max_rows=mr, **dkw)
                self.sync()
                for name, g, w in zip(("label", "dense", "sparse", "valid"), got, want):
                    expect(torch.equal(g, w), f"decode {where}: {name} differs")
            else:
                got = fdxops.fused_decode_transform(vocab, b, max_rows=mr, **fkw)
                err = max(err, self._xform_same(got, wants[i % len(bufs)],
                                                f"fused_decode_transform {where}"))
        expect(_scratch.scan_scratch(dev, stream, 0) is scratch and scratch.epoch == 4,
               f"fused_decode_transform {tag}: epoch {scratch.epoch} after the wrap, expected 4")
        streams = [torch.cuda.Stream() for _ in range(2)]
        outs = [[], []]
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                for _, b, mr in bufs:
                    outs[i].append(fdxops.fused_decode_transform(vocab, b, max_rows=mr, **fkw))
        torch.cuda.synchronize()
        for i, per_stream in enumerate(outs):
            for (what, _, _), got, want in zip(bufs, per_stream, wants):
                err = max(err, self._xform_same(
                    got, want, f"fused_decode_transform {tag} on stream {i} of two, {what}"))
        return err

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
        if not self.rehearse:
            # one decode and one fused_genvocab_slabs a chunk in loop ①
            want = {"decode_scan": len(chunks), "fused_genvocab_slabs": len(chunks)}
            expect(l1 == want, f"{tag} counts loop ①: launched {l1}, expected {want}")
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


    # -- phase 4b ------------------------------------------------------- #
    def _counted(self, kernels: dict, launches: dict, fn):
        """Run ``fn`` with every counter at 0 before it; its result, wall
        seconds and the launches it made (also added to ``launches``)."""
        reset_counters(kernels)
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        seconds = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items() if k.launches}
        for name, n in got.items():
            launches[name] += n
        return out, seconds, got

    def sharded(self, data, tag: str, vocab_range: int) -> dict:
        """The sharded engines at one vocab range: the row-parallel engine
        on every route and shard count, the column-parallel one on each
        mesh, each held to the single-device engine on the same chunks.
        Returns kernel → launches over the phase's runs. Prints what it
        measured, also when a check fails."""
        result = {"phase": "sharded", "schema": tag, "vocab_range": vocab_range,
                  "card": self.smi, "note": SHARDED_NOTE}
        kernels = counters()
        launches = dict.fromkeys(kernels, 0)
        threads = self.torch.get_num_threads()
        if self.rehearse:
            # a rehearsal's thousands of tiny chunk ops run fastest on one
            # thread (41 s against 75 s on eight), and the test suite runs
            # this rehearsal beside its other workers
            self.torch.set_num_threads(1)
        try:
            self._row_parallel(data, tag, vocab_range, kernels, launches, result)
            self._column_parallel(data, tag, vocab_range, kernels, launches, result)
            return launches
        finally:
            self.torch.set_num_threads(threads)
            result["launches"] = launches
            emit(result)

    def _same_state(self, got, want, what: str) -> None:
        torch = self.torch
        for f in ("first_pos", "rows_seen", "counts"):
            a, b = getattr(got, f), getattr(want, f)
            expect((a is None and b is None) or (a is not None and b is not None
                                                 and torch.equal(a, b)),
                   f"{what}: merged state's {f} differs from the single-device engine's")

    def _same_table(self, got, want, what: str) -> None:
        torch = self.torch
        for f in ("label", "dense", "sparse", "valid"):
            expect(torch.equal(getattr(got, f), getattr(want, f)),
                   f"{what}: {f} differs from the single-device engine's")

    def _sharded_feeds(self, data) -> dict:
        """The phase's feeds: the main phase's utf8 buffer and the first
        SHARDED_BINARY_ROWS rows of its binary table, in CHUNK_BYTES chunks
        of at most MAX_ROWS rows; a rehearsal cuts both to
        SHARDED_REHEARSAL's rows in smaller chunks."""
        if self.rehearse:
            rows_u, rows_b, cb, mr = SHARDED_REHEARSAL
        else:
            rows_u, rows_b, cb, mr = data["utf8_rows"], SHARDED_BINARY_ROWS, CHUNK_BYTES, MAX_ROWS
        rows_u, rows_b = min(rows_u, data["utf8_rows"]), min(rows_b, data["binary_rows"])
        end = int(data["utf8_spans"][rows_u - 1][1])
        return {"buf": data["utf8_buf"][:end], "utf8_rows": rows_u,
                "binary": {k: v[:rows_b] for k, v in data["binary"].items()},
                "binary_rows": rows_b, "chunk_bytes": cb, "max_rows": mr}

    def _row_parallel(self, data, tag, vocab_range, kernels, launches, result) -> None:
        torch, np = self.torch, self.np
        from repro_torch.core import pipeline as P, plan as plan_lib
        from repro_torch.core import schema as schema_lib, sharded_pipeline as SP
        from repro_torch.core import vocab as vocab_lib
        from repro_torch.data import loader
        from repro_torch.distributed import sharding
        from repro_torch.launch import mesh as mesh_lib

        sch = dataclasses.replace(schema_lib.CRITEO, vocab_range=vocab_range)
        feeds = self._sharded_feeds(data)
        cb = feeds["chunk_bytes"]
        base = P.PipelineConfig(schema=sch, chunk_bytes=cb, max_rows_per_chunk=feeds["max_rows"],
                                device=str(self.dev))
        result["feeds"] = {"utf8_rows": feeds["utf8_rows"], "binary_rows": feeds["binary_rows"],
                           "binary_rows_cut_from": data["binary_rows"], "chunk_bytes": cb,
                           "max_rows": feeds["max_rows"]}
        routes = dict(SHARDED_ROUTES)
        runs = [(route, n) for route in routes for n in SHARD_COUNTS]
        crossed, crossed_n, crossed_tag = SHARDED_CROSSED
        if tag == crossed_tag:
            routes[crossed] = ("utf8", {"plan": plan_lib.crossed_criteo(sch)},
                               ("decode_scan", "fused_genvocab"),
                               ("decode_scan", "fused_transform"))
            runs.append((crossed, crossed_n))
        for route, n in runs:
            feed, fields, k1, k2 = routes[route]
            cfg = dataclasses.replace(base, input_format=feed, **fields)
            if feed == "utf8":
                f = loader.TabularChunkFeed(feeds["buf"], cb, n)
                flat, rows = f.stacked.reshape(-1, cb), feeds["utf8_rows"]
                chunks = list(flat)
            else:
                f = loader.BinaryChunkFeed(feeds["binary"], feeds["max_rows"], n)
                flat, rows = f.flat_chunks(), feeds["binary_rows"]
                chunks = [{k: v[i] for k, v in flat.items()} for i in range(len(flat["label"]))]
            mesh = mesh_lib.make_data_mesh(n, device=str(self.dev))
            eng = SP.ShardedPiperPipeline(cfg, mesh)
            cs, os_ = sharding.put_shard_feed(*f.shard_stacks(), mesh)
            total = f.n_steps * n  # chunks, pad chunks included
            what = f"{tag} sharded {route} x{n}"
            counted = functools.partial(self._counted, kernels, launches)
            state, s1, l1 = counted(lambda: eng.build_state_scan(cs, os_))
            voc, _, lv = counted(lambda: eng.build_vocab_scan(cs, os_))
            out, s2, l2 = counted(lambda: eng.transform_scan(voc, cs))
            scan, s_scan, l_scan = counted(lambda: eng.run_scan(cs, os_))

            single = P.PiperPipeline(cfg)
            self._same_state(state, single.build_state_stream(chunks), what)
            voc_1 = single.build_vocab_scan(flat)
            expect(torch.equal(voc.table, voc_1.table) and torch.equal(voc.sizes, voc_1.sizes),
                   f"{what}: build_vocab_scan differs from the single-device engine's")
            want = P.flatten_processed(single.transform_scan(voc_1, flat))
            self._same_table(SP.flatten_sharded(out), want, f"{what} transform_scan")
            self._same_table(SP.flatten_sharded(scan), want, f"{what} run_scan")
            del out, scan, want
            if not self.rehearse:
                each = lambda names: {k: total * names.count(k) for k in names}  # noqa: E731
                for loop, got, exp in (("loop ①", l1, each(k1)), ("build_vocab_scan", lv, each(k1)),
                                       ("loop ②", l2, each(k2)),
                                       ("run_scan", l_scan, each(k1 + k2))):
                    expect(got == exp, f"{what} {loop}: launched {got}, expected {exp}")
            # each loop again, warm, for its spread
            rep1 = self.wall_seconds(lambda: eng.build_state_scan(cs, os_), n=3)
            rep2 = self.wall_seconds(lambda: eng.transform_scan(voc, cs), n=3)
            rec = {"chunks": total, "steps": f.n_steps, "rows": rows,
                   "routes": {"loop1": eng._loop1_labels["route"],
                              "loop2": eng._loop2_labels["route"]},
                   "loop1_s": s1, "loop1_repeat_s": rep1,
                   "loop1_rows_per_s_median": rows / statistics.median(rep1),
                   "loop2_s": s2, "loop2_repeat_s": rep2,
                   "loop2_rows_per_s_median": rows / statistics.median(rep2),
                   "run_scan_s": s_scan, "run_scan_rows_per_s": rows / s_scan,
                   "run_scan_launches": l_scan}
            if route == "utf8" and n == max(SHARD_COUNTS):
                rec["merge_tree"] = self._merge_tree_ms(eng, cs, os_)
            result.setdefault(route, {})[f"x{n}"] = rec
            del state, voc, voc_1, cs, os_, eng

    def _merge_tree_ms(self, eng, cs, os_) -> dict:
        """Device ms of the merge tree over the engine's per-shard states,
        beside its bound: each halving level reads two states and writes
        one for each merge."""
        from repro_torch.core import sharded_pipeline as SP, vocab as vocab_lib

        states = eng.shard_states(cs, os_)
        stacked = SP.stack_states(states, eng.devices[0])
        n = int(stacked.first_pos.shape[0])
        state_bytes = stacked.first_pos[0].numel() * 4 + 4
        moved, p = 0, 1 << max(n - 1, 0).bit_length()
        while p > 1:
            p //= 2
            moved += 3 * p * state_bytes
        t = self.time_ms(lambda: vocab_lib.merge_tree(stacked), reps=10)
        stack_ms = self.event_ms(lambda: SP.stack_states(states, eng.devices[0]), reps=3,
                                 warmup=1)
        bound_ms, bound_by = bound(moved, 0)
        return {"shards": n, "state_bytes": state_bytes, "bytes_moved": moved,
                "ms": t["device_ms"], "call_ms": t["call_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "stack_states_call_ms": stack_ms}

    def _column_parallel(self, data, tag, vocab_range, kernels, launches, result) -> None:
        torch = self.torch
        from repro_torch.core import pipeline as P, schema as schema_lib, sharded as Sh
        from repro_torch.core import vocab as vocab_lib
        from repro_torch.data import loader
        from repro_torch.kernels.vocab import ops as vops, ref as vref
        from repro_torch.launch import mesh as mesh_lib

        sch = dataclasses.replace(schema_lib.CRITEO, vocab_range=vocab_range)
        feeds = self._sharded_feeds(data)
        cb = feeds["chunk_bytes"]
        cfg = P.PipelineConfig(schema=sch, chunk_bytes=cb, max_rows_per_chunk=feeds["max_rows"],
                               device=str(self.dev))
        single = P.PiperPipeline(cfg)
        counted = functools.partial(self._counted, kernels, launches)
        for name, (shape, axes) in COLUMN_MESHES.items():
            eng = Sh.ShardedPiper(cfg, mesh_lib.make_mesh(shape, axes, devices=str(self.dev)))
            f = loader.TabularChunkFeed(feeds["buf"], cb, eng.n_row_shards)
            chunks = torch.from_numpy(f.stacked).to(self.dev)
            offs = torch.from_numpy(f.offsets).to(self.dev)
            what = f"{tag} ShardedPiper {name}"

            def loop1():
                state = eng.init_state()
                for i in range(f.n_steps):
                    state = eng.vocab_step(state, chunks[i], offs[i])
                return state

            state, s1, l1 = counted(loop1)
            fin = self.time_ms(lambda: eng.finalize(state), reps=5, warmup=1)
            vocab = eng.finalize(state)
            table = eng.stacked_vocabulary(vocab)
            out, s_scan, l_scan = counted(lambda: eng.run_scan(chunks, offs))

            flat = f.stacked.reshape(-1, cb)
            voc_1 = single.build_vocab_scan(flat)
            want = P.flatten_processed(single.transform_scan(voc_1, flat))
            n_sp = sch.n_sparse
            expect(torch.equal(table.table[:n_sp], voc_1.table)
                   and torch.equal(table.sizes[:n_sp], voc_1.sizes),
                   f"{what}: the vocabulary's first {n_sp} rows differ from the single-device "
                   "table")
            v = out.valid.reshape(-1)
            sparse = out.sparse.reshape(-1, eng.cols_pad)
            expect(torch.equal(v, want.valid), f"{what}: valid differs")
            expect(torch.equal(sparse[v, :n_sp], want.sparse[v]), f"{what}: sparse ids differ")
            expect(not bool(sparse[:, n_sp:].any()), f"{what}: a padding column is not 0")
            expect(torch.equal(out.label.reshape(-1)[v], want.label[v]), f"{what}: labels differ")
            expect(torch.equal(out.dense.reshape(-1, sch.n_dense)[v], want.dense[v]),
                   f"{what}: dense differs")
            checks = self._column_kernel_checks(eng, chunks, offs, vocab, vops, vref, vocab_lib)
            positions = eng.n_row_shards * eng.model_size
            if not self.rehearse:
                per = f.n_steps * positions
                for loop, got, exp in (
                        ("loop ①", l1, {"decode_scan": per, "genvocab": per}),
                        ("run_scan", l_scan, {"decode_scan": 2 * per, "genvocab": per,
                                              "apply_vocab": per, "dense_transform": per})):
                    expect(got == exp, f"{what} {loop}: launched {got}, expected {exp}")
            rows = feeds["utf8_rows"]
            result.setdefault("column_parallel", {})[name] = {
                "mesh": dict(zip(axes, shape)), "cols_pad": eng.cols_pad,
                "cols_local": eng.cols_local, "steps": f.n_steps, "positions": positions,
                "loop1_s": s1, "loop1_rows_per_s": rows / s1,
                "finalize_ms": fin["device_ms"], "finalize_call_ms": fin["call_ms"],
                "run_scan_s": s_scan, "run_scan_rows_per_s": rows / s_scan,
                "run_scan_launches": l_scan, "kernel_checks": checks}
            del state, vocab, out, want

    def _column_kernel_checks(self, eng, chunks, offs, vocab, vops, vref, vocab_lib) -> dict:
        """genvocab and apply_vocab at ShardedPiper's block shape (the last
        model shard's columns, padding included, of the first chunk) against
        their plain versions on the same inputs; uncounted."""
        torch = self.torch
        m = eng.model_size - 1
        dev = eng.devices[0][m]
        local, batch = eng._local(chunks[0][0], dev, m)
        fp = eng.init_state()[0][m]
        pos = vocab_lib.positions(offs[0][0], local.shape[0], batch.valid)
        want_fp = vref.genvocab(fp.clone(), local.t(), pos)
        got_fp = vops.genvocab_update(vocab_lib.VocabState(fp, offs[0][0]), local,
                                      batch.valid).first_pos
        want_ids = vref.apply_vocab(vocab[0][m].table, local.t()).t()
        got_ids = vops.apply_vocab(vocab[0][m].table, local)
        expect(torch.equal(got_fp, want_fp), "ShardedPiper block: genvocab differs from plain")
        expect(torch.equal(got_ids, want_ids), "ShardedPiper block: apply_vocab differs from plain")
        err = lambda a, b: int((a.long() - b.long()).abs().max()) if a.numel() else 0  # noqa: E731
        return {"shape": list(local.shape), "genvocab_max_abs_err": err(got_fp, want_fp),
                "apply_vocab_max_abs_err": err(got_ids, want_ids)}

    # -- phase 7 -------------------------------------------------------- #
    def stream(self, data, tag: str, vocab_range: int) -> dict:
        """The streaming service at one vocab range on every stream route.
        Returns kernel → launches over the phase's path (each route's
        served pass and its absorbs). Prints what it measured, also when a
        check fails."""
        result = {"phase": "stream", "schema": tag, "vocab_range": vocab_range,
                  "card": self.smi}
        kernels = counters()
        launches = dict.fromkeys(kernels, 0)
        try:
            for route in STREAM_ROUTES:
                result[route] = {}
                self._stream_route(data, vocab_range, route, kernels, launches,
                                   result[route])
            return launches
        finally:
            result["launches"] = launches
            emit(result)

    def _stream_payloads(self, data, feed: str, lo: int, sizes):
        """Consecutive payloads of ``sizes`` rows from row ``lo`` of a feed."""
        if feed == "utf8":
            spans = data["utf8_spans"]
            out, row = [], lo
            for n in sizes:
                out.append(data["utf8_buf"][spans[row, 0]:spans[row + n - 1, 1]])
                row += n
            return out
        table, out, row = data["binary"], [], lo
        for n in sizes:
            out.append({k: table[k][row:row + n] for k in ("label", "dense", "sparse")})
            row += n
        return out

    def _stream_chunks(self, data, feed: str, lo: int, hi: int) -> list:
        """Rows [lo, hi) of a feed as the offline engine's chunks."""
        from repro_torch.data import loader, synth

        if feed == "utf8":
            spans = data["utf8_spans"]
            return list(synth.chunk_stream(
                data["utf8_buf"][spans[lo, 0]:spans[hi - 1, 1]], CHUNK_BYTES))
        part = {k: v[lo:hi] for k, v in data["binary"].items()}
        stacked = loader.BinaryChunkFeed(part, MAX_ROWS).flat_chunks()
        return [{k: v[i] for k, v in stacked.items()} for i in range(len(stacked["label"]))]

    def _offline_rows(self, pipe, vocab, chunks) -> dict:
        """The valid rows of loop ② over ``chunks`` under ``vocab``, on the
        host."""
        outs = list(pipe.transform_stream(vocab, chunks))
        return {f: self.torch.cat([getattr(o, f)[o.valid] for o in outs]).cpu().numpy()
                for f in ("label", "dense", "sparse")}

    def _served_as(self, outs, want: dict, row0: int, what: str) -> int:
        """Each request's output against the offline rows from ``row0`` on;
        returns the row after the last."""
        np = self.np
        for i, out in enumerate(outs):
            n = out["label"].shape[0]
            for f in ("label", "sparse"):
                expect(out[f].dtype == np.int32 and np.array_equal(
                    out[f], want[f][row0:row0 + n]),
                    f"{what}: request {i} {f} differs from the offline table")
            expect(np.allclose(out["dense"], want["dense"][row0:row0 + n], rtol=1e-6, atol=0),
                   f"{what}: request {i} dense beyond rtol 1e-6 of the offline table")
            row0 += n
        return row0

    def _wait_applied(self, svc, n: int, what: str) -> None:
        counter = svc.registry.counter("stream.vocab_apply_total")
        deadline = time.monotonic() + STREAM_WAIT_S
        while counter.value < n:
            expect(time.monotonic() < deadline, f"{what}: the vocabulary swap was never applied")
            time.sleep(0.001)

    def _absorb_from_thread(self, svc, payload, what: str) -> None:
        import threading

        errors = []

        def absorb():
            try:
                svc.absorb(payload)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        t = threading.Thread(target=absorb, name="absorb")
        t.start()
        t.join(timeout=STREAM_WAIT_S)
        expect(not t.is_alive(), f"{what}: absorb did not return")
        expect(not errors, f"{what}: absorb raised {errors!r}")

    def _stream_route(self, data, vocab_range: int, route: str, kernels, launches, rec) -> None:
        torch, np = self.torch, self.np
        from repro_torch.core import pipeline as P
        from repro_torch.core import schema as schema_lib, vocab as vocab_lib
        from repro_torch.data import chunk_cache
        from repro_torch.stream import StreamingPreprocessService, scheduler

        feed, fields, per_batch = STREAM_ROUTES[route]
        buckets = REHEARSAL_STREAM_BUCKETS if self.rehearse else STREAM_BUCKETS
        rows = min(STREAM_ROWS, data[f"{feed}_rows"])
        half = rows // 2
        sch = dataclasses.replace(schema_lib.CRITEO, vocab_range=vocab_range)
        offline_cfg = P.PipelineConfig(schema=sch, device=str(self.dev), input_format=feed,
                                       **fields)
        # absorb takes one payload of the largest bucket in one chunk
        svc_cfg = dataclasses.replace(offline_cfg, max_rows_per_chunk=buckets[-1],
                                      chunk_bytes=buckets[-1] * sch.max_row_bytes)
        pipe = P.PiperPipeline(offline_cfg)
        state_half = pipe.build_state_stream(self._stream_chunks(data, feed, 0, half))
        second = self._stream_chunks(data, feed, half, rows)
        vocab_half = vocab_lib.finalize(state_half)
        want = self._offline_rows(pipe, vocab_half, second)
        rng = np.random.default_rng(0)
        split = STREAM_SPLIT_ROWS["rehearsal" if self.rehearse else "card"]
        sizes, left = [split], rows - half - split
        while left > 0:
            n = int(min(rng.integers(1, STREAM_MAX_REQUEST + 1), left))
            sizes.append(n)
            left -= n
        payloads = self._stream_payloads(data, feed, half, sizes)
        absorbed = self._stream_payloads(data, feed, half, [buckets[-1]])[0]
        what = f"stream {vocab_range} {route}"

        def clone(st):
            return vocab_lib.VocabState(st.first_pos.clone(), st.rows_seen.clone(),
                                        None if st.counts is None else st.counts.clone())

        def served(svc, batch_payloads):
            handles = [svc.submit(p) for p in batch_payloads]
            svc.drain(timeout=STREAM_WAIT_S)
            return [h.result(timeout=STREAM_WAIT_S) for h in handles], handles

        def counted(fn):
            reset_counters(kernels)
            self.sync()
            out = fn()
            self.sync()
            got = {name: k.launches for name, k in kernels.items() if k.launches}
            for name, n in got.items():
                launches[name] += n
            return out, got

        svc = StreamingPreprocessService(svc_cfg, clone(state_half), bucket_rows=buckets)
        recompiles = svc.registry.counter("stream.recompiles_total")
        batches = svc.registry.counter("stream.batches_total")
        with svc:
            svc.warmup(self._stream_payloads(data, feed, half, [c])[0] for c in buckets)
            rec["recompiles_after_warmup"] = recompiles.value
            expect(recompiles.value == len(buckets),
                   f"{what}: {recompiles.value} recompiles after warm-up, expected {len(buckets)}")
            overlap = svc.registry.counter("stream.overlap_assembly_s")
            stall0, overlap0, b0 = svc.stall_report()["buckets_s"], overlap.value, batches.value
            (outs, handles), got = counted(lambda: served(svc, payloads))
            n_batches = batches.value - b0
            stall = svc.stall_report()["buckets_s"]
            expect(isinstance(handles[0], scheduler.CompositeRequest)
                   and len(handles[0].parts) > 1, f"{what}: the {split}-row request did not split")
            expect(self._served_as(outs, want, 0, f"{what} pass 1") == rows - half,
                   f"{what}: pass 1 served a different row count")
            expect(self.rehearse or got == {k: n_batches for k in per_batch},
                   f"{what}: {n_batches} micro-batches launched {got}, expected each of "
                   f"{per_batch} once a batch")
            # the pass's own stall split (the loop's counters less the
            # warm-up's) and its overlap
            rec.update(requests=len(payloads), rows=rows - half, batches=n_batches,
                       metrics=svc.metrics.snapshot(),
                       stall_s={b: stall[b] - stall0[b] for b in stall},
                       overlap_assembly_s=overlap.value - overlap0,
                       occupancy=svc.registry.get("stream.bucket_occupancy").snapshot())
            expect(recompiles.value == len(buckets), f"{what}: recompiles grew in the pass")

            # one micro-batch per bucket, by the profiler: exactly the
            # route's kernels, and the copies in and back
            one = {c: self._stream_payloads(data, feed, half, [c])[0] for c in buckets}
            rec["device_ms_per_batch"], rec["device_work_per_batch"] = {}, {}
            for c in buckets:
                def batch(c=c):
                    svc.submit(one[c]).result(timeout=STREAM_WAIT_S)
                per = self.kernels_per_call(batch)
                stages = self.stages(batch)
                rec["device_work_per_batch"][c] = per
                rec["device_ms_per_batch"][c] = stages
                if per is not None:
                    found = {k: v for k, v in per.items() if not k.startswith(("Memcpy", "Memset"))}
                    expect(sum(found.values()) == len(per_batch),
                           f"{what}: a {c}-row batch ran kernels {per}, expected {per_batch}")
            if feed == "utf8":
                rec["padding_ms"] = self._padding_ms(route, one, vocab_half, sch)
            # the device's busy share of one window of requests
            window = payloads[1:129]
            walls = self.wall_seconds(lambda: served(svc, window), n=3)
            busy = self.device_seconds(lambda: served(svc, window))
            rec["window"] = {"requests": len(window),
                             "rows": sum(sizes[1:129]),
                             "wall_s": walls,
                             "busy_share": None if busy is None
                             else busy / statistics.median(walls)}

            # absorb from a second thread, then the same rows in loop ①
            # offline, in the main path's chunks (no zero padding, kernels
            # held to their plain versions at that shape by the main
            # phase) and in absorb's one padded chunk: the merged state
            # must match both bit for bit
            applied = svc.registry.counter("stream.vocab_apply_total").value
            _, got = counted(lambda: self._absorb_from_thread(svc, absorbed, what))
            self._wait_applied(svc, applied + 1, what)
            pipe_abs = P.PiperPipeline(svc_cfg)
            offline = pipe_abs.vocab_step(clone(state_half),
                                          self._padded(svc_cfg, absorbed))
            cut = self._loop1_cut(pipe, clone(state_half), data, feed, half, buckets[-1])
            merged = svc.vocab_state
            for f in ("first_pos", "rows_seen"):
                expect(torch.equal(getattr(merged, f), getattr(cut, f)),
                       f"{what}: absorbed state {f} differs from offline loop ① in "
                       "the main path's chunks")
                expect(torch.equal(getattr(merged, f), getattr(offline, f)),
                       f"{what}: absorbed state {f} differs from offline loop ①")
            rec["absorb"] = {"launches": got, "rows": buckets[-1],
                             "swap_device_s": svc.last_swap_seconds(),
                             "swap_host_s": svc.registry.get("stream.vocab_swap_s").snapshot()}
            # loop ① at absorb's chunk (the largest bucket's geometry), by
            # kernel and copy: the absorbed payload again, into a copy
            chunk, st = self._padded(svc_cfg, absorbed), clone(state_half)
            rec["absorb"]["device_ms"] = self.stages(lambda: pipe_abs.vocab_step(st, chunk))
            want2 = self._offline_rows(pipe, vocab_lib.finalize(offline), second)
            (outs2, _), _ = counted(lambda: served(svc, payloads))
            self._served_as(outs2, want2, 0, f"{what} pass 2 (after absorb)")
            rec["recompiles_after_swap"] = recompiles.value
            expect(recompiles.value == len(buckets),
                   f"{what}: {recompiles.value} recompiles after the swap")
            rec["compile_cache_size"] = svc.compile_cache_size()

        if route == "utf8":
            rec["counts"] = self._stream_counts(data, sch, offline_cfg, svc_cfg, buckets, half,
                                                absorbed, clone, counted, what)

        # the chunk cache: a first pass fills it, the second hits everywhere
        cache = chunk_cache.ChunkCache(capacity_bytes=1 << 30)
        svc = StreamingPreprocessService(svc_cfg, clone(offline), bucket_rows=buckets,
                                         cache=cache)
        with svc:
            first, handles = served(svc, payloads)
            leaves = sum(len(getattr(h, "parts", [h])) for h in handles)
            batches = svc.registry.counter("stream.batches_total")
            b0, hits0 = batches.value, cache.stats()["hits_total"]
            again, _ = served(svc, payloads)
            stats = cache.stats()
            expect(stats["hits_total"] - hits0 == leaves,
                   f"{what}: {stats['hits_total'] - hits0} cache hits of {leaves} requests")
            expect(batches.value == b0, f"{what}: a cached pass dispatched")
            self._served_as(again, want2, 0, f"{what} cached pass")
            for a, b in zip(first, again):
                for f in ("label", "dense", "sparse"):
                    expect(np.array_equal(a[f], b[f]), f"{what}: a cache hit differs")
            rec["cache"] = {"stats": stats, "metrics": svc.metrics.snapshot(),
                            "vocab_digest_s": svc.registry.get("stream.vocab_digest_s").snapshot()}

    def _padding_ms(self, route: str, one: dict, vocab, sch) -> dict:
        """Device ms of the route's one-launch scan on each bucket's chunk
        (the rows, then zeros to rows x max_row_bytes, as the scheduler pads
        them) and on the same rows cut at their end (16-byte aligned)."""
        torch, np = self.torch, self.np
        from repro_torch.kernels.decode_utf8 import ops as dops
        from repro_torch.kernels.fused_decode_xform import ops as fdxops

        out = {}
        for c, payload in one.items():
            padded = np.zeros(c * sch.max_row_bytes, np.uint8)
            padded[:payload.size] = payload
            cut = padded[:-(-payload.size // 16) * 16]
            times = {}
            for what, buf in (("padded", padded), ("cut", cut)):
                b = torch.from_numpy(buf).to(self.dev)
                if route == "utf8":
                    fn = lambda b=b: dops.decode(  # noqa: E731
                        b, sch.field_is_hex(), n_fields=sch.n_fields, max_rows=c,
                        n_dense=sch.n_dense, n_sparse=sch.n_sparse)
                else:
                    fn = lambda b=b: fdxops.fused_decode_transform(  # noqa: E731
                        vocab, b, n_fields=sch.n_fields, hex_start=1 + sch.n_dense, max_rows=c)
                times[what] = {"bytes": int(buf.size), **self.time_ms(fn)}
            out[c] = times
        return out

    def _padded(self, cfg, payload):
        """One payload padded to ``cfg``'s chunk, as absorb pads it."""
        from repro_torch.stream import make_request, service

        return service.padded_chunk(make_request(payload, cfg), cfg)

    def _loop1_cut(self, pipe, state, data, feed: str, lo: int, rows: int):
        """Loop ① from ``state`` over rows [lo, lo + rows) in the offline
        engine's chunks (1 MiB utf8, 16384-row binary), as the main path
        cuts them."""
        for chunk in self._stream_chunks(data, feed, lo, lo + rows):
            state = pipe.vocab_step(state, chunk)
        return state

    def _stream_counts(self, data, sch, offline_cfg, svc_cfg, buckets, half, absorbed, clone,
                       counted, what) -> dict:
        """absorb with the count plane (fused_genvocab_slabs after decode) into
        a top-k service: the merged state, counts included, must equal
        offline loop ① over the same rows in order."""
        torch = self.torch
        from repro_torch.core import pipeline as P, vocab as vocab_lib
        from repro_torch.stream import StreamingPreprocessService

        k = sch.vocab_range // 10
        cfg = dataclasses.replace(offline_cfg, track_vocab_counts=True)
        svc_cfg = dataclasses.replace(svc_cfg, track_vocab_counts=True)
        state = P.PiperPipeline(cfg).build_state_stream(
            self._stream_chunks(data, "utf8", 0, half))
        svc = StreamingPreprocessService(svc_cfg, clone(state), bucket_rows=buckets,
                                         finalizer=lambda st: vocab_lib.finalize_topk(st, k))
        with svc:
            _, got = counted(lambda: self._absorb_from_thread(svc, absorbed, what))
            self._wait_applied(svc, 1, f"{what} counts")
            merged = svc.vocab_state
        offline = P.PiperPipeline(svc_cfg).vocab_step(clone(state),
                                                      self._padded(svc_cfg, absorbed))
        cut = self._loop1_cut(P.PiperPipeline(cfg), clone(state), data, "utf8", half,
                              buckets[-1])
        for f in ("first_pos", "counts", "rows_seen"):
            expect(torch.equal(getattr(merged, f), getattr(cut, f)),
                   f"{what} counts: absorbed state {f} differs from offline loop ① in "
                   "the main path's chunks")
            expect(torch.equal(getattr(merged, f), getattr(offline, f)),
                   f"{what} counts: absorbed state {f} differs from offline loop ①")
        if not self.rehearse:
            expect(got == {"decode_scan": 1, "fused_genvocab_slabs": 1},
                   f"{what} counts: absorb launched {got}")
        chunk, st = self._padded(svc_cfg, absorbed), clone(state)
        pipe = P.PiperPipeline(svc_cfg)
        return {"k": k, "launches": got, "swap_device_s": svc.last_swap_seconds(),
                "device_ms": self.stages(lambda: pipe.vocab_step(st, chunk))}

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
        it = input_pipeline.stream_batches(outs, batch_rows=batch_rows, n_steps=n_steps)
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
        if final is not None:  # the e2e phase's run_stream-fed weights
            self.train_params[tag] = final[:len(leaves(model.params_tree()))]
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

    # -- phase 8 -------------------------------------------------------- #
    def e2e(self, data, tag: str) -> dict:
        """Piper → DLRM training fed by the streaming service at one range,
        through launch/train_dlrm_e2e's functions: overlap off and on (and
        at 5K a cold, then warm chunk cache), each run's launches counted
        on its own. Returns kernel → launches over the phase's path. Prints
        what it measured, also when a check fails."""
        result = {"phase": "e2e", "range": tag, "card": self.smi}
        try:
            return self._e2e(data, tag, result)
        finally:
            emit(result)

    def _e2e(self, data, tag: str, result: dict) -> dict:
        torch, dev = self.torch, self.dev
        from repro_torch.configs import piper_dlrm
        from repro_torch.data import chunk_cache
        from repro_torch.launch import train_dlrm_e2e
        from repro_torch.train import optimizer
        from repro_torch.train.tree import leaves

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = {"5K": piper_dlrm.CONFIG_5K, "1M": piper_dlrm.CONFIG_1M}[tag]
        batch_rows, n_steps = TRAIN_BATCH, TRAIN_STEPS[tag]
        if self.rehearse:  # the train phase's rehearsal sizes
            vr = REHEARSAL_RANGES[tag]
            cfg = dataclasses.replace(
                cfg, schema=dataclasses.replace(cfg.schema, vocab_range=vr),
                model=dataclasses.replace(cfg.model, vocab_range=vr))
            batch_rows, n_steps = REHEARSAL_TRAIN_BATCH, REHEARSAL_TRAIN_STEPS[tag]
        else:
            gc.collect()  # an earlier phase's tensors that wait on a reference cycle
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        result.update(config=cfg.name, vocab_range=cfg.model.vocab_range,
                      batch_rows=batch_rows, steps=n_steps)
        kernels = counters()
        launches = dict.fromkeys(kernels, 0)

        def count(into: dict) -> dict:
            got = {k: v.launches for k, v in kernels.items() if v.launches}
            for k, v in got.items():
                into[k] += v
            return got

        t0 = time.perf_counter()
        reset_counters(kernels)
        feed = train_dlrm_e2e.prepare(data["utf8_buf"], cfg.schema, payload_rows=batch_rows,
                                      device=str(dev))
        result.update(loop1_s=feed.loop1_s, loop1_launches=count(launches),
                      payloads=len(feed.payloads), prepare_s=time.perf_counter() - t0)
        ocfg = optimizer.AdamWConfig()  # the train phase's, so the weights compare
        runs = result["runs"] = {}
        first = None  # run a's parameters
        svc = train_dlrm_e2e.start_service(feed)
        try:
            # a short unrecorded pass first: a process's first train steps
            # carry one-time costs (cuBLAS and autograd set-up, the
            # allocator's first blocks) that would fall on run a alone
            train_dlrm_e2e.train(svc, feed, cfg.model, ocfg, steps=E2E_WARMUP_STEPS,
                                 batch=batch_rows, overlap=False)
            for name, overlap, cache in E2E_RUNS[tag]:
                if cache == "fresh":
                    svc.stop()
                    svc = train_dlrm_e2e.start_service(
                        feed, chunk_cache.ChunkCache(capacity_bytes=E2E_CACHE_BYTES))
                rec = runs[name] = {"overlap": overlap, "cache": cache}
                svc.drain(timeout=E2E_WAIT_S)  # a quiet service: this run's counts alone
                reg = svc.registry
                reg.reset()
                cached = svc.cache.stats() if svc.cache is not None else None
                reset_counters(kernels)
                report, model = train_dlrm_e2e.train(svc, feed, cfg.model, ocfg, steps=n_steps,
                                                     batch=batch_rows, overlap=overlap)
                svc.drain(timeout=E2E_WAIT_S)
                got = count(launches)
                rec.update({k: report[k] for k in ("wall_s", "ms_per_step", "rows_per_s",
                                                   "e2e_stall", "e2e_counters")})
                rec.update(loss_first=report["losses"][0], loss_last=report["losses"][-1],
                           launches=got, launches_per_step={k: v / n_steps for k, v in got.items()},
                           service_stall=svc.stall_report(),
                           service_batches=reg.get("stream.batches_total").value)
                if cached is not None:
                    now = svc.cache.stats()
                    rec["cache_delta"] = {k: now[k] - cached[k]
                                          for k in ("hits_total", "misses_total")}
                expect(all(math.isfinite(x) for x in report["losses"]),
                       f"e2e {tag} {name}: a loss is not finite")
                if not self.rehearse:
                    want = {"embedding_gather": n_steps, "embedding_gather_backward": n_steps}
                    if cache != "warm":
                        want.update(decode_scan=rec["service_batches"],
                                    fused_transform=rec["service_batches"])
                    expect(got == want, f"e2e {tag} {name}: launched {got}, expected {want}")
                if cache == "warm":
                    d = rec["cache_delta"]
                    expect(rec["service_batches"] == 0 and d["misses_total"] == 0
                           and d["hits_total"] >= n_steps and not got.get("decode_scan"),
                           f"e2e {tag} {name}: the warm run dispatched ({rec})")
                params = [p.detach() for p in leaves(model.params_tree())]
                if first is None:
                    first = [p.clone() for p in params]
                else:
                    for i, (a, b) in enumerate(zip(params, first)):
                        expect(torch.equal(a, b), f"e2e {tag} {name}: parameter leaf {i} "
                               "differs from run a's")
                del model, params
                if not self.rehearse:
                    torch.cuda.empty_cache()
            result["staging"] = self._staging(svc, feed)
        finally:
            svc.stop()
        result["weights_bit_identical"] = list(runs)
        if tag == "5K":
            self._e2e_against_run_stream(data, cfg, ocfg, batch_rows, n_steps, first, result)
            result["oracle"] = self._oracle(data, launches)
        if not self.rehearse:
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["launches"] = {k: v for k, v in launches.items() if v}
        return launches

    def _e2e_against_run_stream(self, data, cfg, ocfg, batch_rows, n_steps, want,
                                result: dict) -> None:
        """The same rows and steps fed by run_stream (stream_batches over the
        offline engine's output, the train phase's route) from the same seed
        end in the same weights, bit for bit; so do the train phase's own,
        when it ran."""
        torch, dev = self.torch, self.dev
        from repro_torch.core import pipeline as P
        from repro_torch.models import dlrm
        from repro_torch.train import input_pipeline, optimizer, steps
        from repro_torch.train.tree import leaves

        outs = list(P.PiperPipeline(cfg.pipeline_config(device=str(dev))).run_stream(
            lambda: iter(data["utf8_chunks"])))
        model = dlrm.DLRM(cfg.model, device=dev, generator=torch.Generator(dev).manual_seed(0))
        opt = optimizer.adamw_init(model.params_tree())
        step = steps.make_tabular_train_step(dlrm.loss, ocfg)
        for batch in input_pipeline.stream_batches(outs, batch_rows=batch_rows, n_steps=n_steps):
            step(model, opt, batch)
        sources = {"run_stream": [p.detach() for p in leaves(model.params_tree())]}
        if "5K" in self.train_params:
            sources["train_phase"] = self.train_params["5K"]
        for what, params in sources.items():
            for i, (a, b) in enumerate(zip(params, want)):
                expect(torch.equal(a, b), f"e2e 5K: parameter leaf {i} of the {what}-fed "
                       "run differs from the service-fed runs'")
        result["equal_to"] = list(sources)

    def _staging(self, svc, feed) -> dict:
        """What one batch's round trip costs: the service's result (host
        numpy) copied into pinned buffers and to the card on a side stream
        (PinnedStager.stage, host clock to the copy's end, after every slot
        was made), the copy in and the copy back (device to pinned) alone by
        CUDA events, each averaged over 20 batches; None in a rehearsal."""
        if self.rehearse:
            return None
        torch = self.torch
        from repro_torch.data import loader

        host = svc.submit(feed.payloads[0]).result(timeout=E2E_WAIT_S)
        stager = loader.PinnedStager(self.dev, slots=4)
        side = torch.cuda.Stream(self.dev)
        reps, warm, secs = 20, 8, []  # the warm-up fills every slot twice
        with torch.cuda.stream(side):
            for i in range(warm + reps):
                t0 = time.perf_counter()
                out, event = stager.stage(host)
                event.synchronize()
                if i >= warm:
                    secs.append(time.perf_counter() - t0)
            pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}
            h2d = self.event_ms(lambda: [t.to(self.dev, non_blocking=True)
                                         for t in pinned.values()], reps=reps)
            back = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for k, t in pinned.items()}
            d2h = self.event_ms(lambda: [back[k].copy_(t, non_blocking=True)
                                         for k, t in out.items()], reps=reps)
        torch.cuda.synchronize()
        return {"bytes_per_batch": sum(v.nbytes for v in host.values()),
                "stage_ms": statistics.mean(secs) * 1e3, "h2d_ms": h2d, "d2h_ms": d2h,
                "pinned_buffers": stager.pinned_buffers()}

    def _oracle(self, data, launches: dict) -> dict:
        """The engine on the card (both loops, default hints) against the
        row-wise CPU baseline (core/baseline.py, 4 threads) over the first
        ORACLE_ROWS rows of the utf8 feed and of the binary table, at 5K:
        labels and ids bit for bit, dense at rtol 1e-6."""
        np, torch, dev = self.np, self.torch, self.dev
        from repro_torch.core import baseline, pipeline as P
        from repro_torch.core import schema as schema_lib
        from repro_torch.data import loader, synth

        rows = ORACLE_ROWS["rehearsal" if self.rehearse else "card"]
        kernels = counters()
        reset_counters(kernels)
        spans = data["utf8_spans"]
        buf = data["utf8_buf"][:spans[rows - 1, 1]]
        part = {k: v[:rows] for k, v in data["binary"].items()}
        flat = loader.BinaryChunkFeed(part, MAX_ROWS).flat_chunks()
        feeds = {
            "utf8": (P.PipelineConfig(device=str(dev)),
                     lambda: synth.chunk_stream(buf, CHUNK_BYTES),
                     lambda: baseline.run_pipeline(buf, schema_lib.CRITEO, n_threads=4)),
            "binary": (P.PipelineConfig(device=str(dev), input_format="binary"),
                       lambda: ({k: v[i] for k, v in flat.items()}
                                for i in range(len(flat["label"]))),
                       lambda: baseline.run_pipeline(None, schema_lib.CRITEO, n_threads=4,
                                                     binary_input=part)),
        }
        out = {"rows": rows}
        for name, (config, chunks, oracle) in feeds.items():
            outs = list(P.PiperPipeline(config).run_stream(chunks))
            got = {f: torch.cat([getattr(o, f)[o.valid] for o in outs]).cpu().numpy()
                   for f in ("label", "dense", "sparse")}
            t0 = time.perf_counter()
            want = oracle()
            out[f"{name}_baseline_s"] = time.perf_counter() - t0
            for f in ("label", "sparse"):
                expect(got[f].dtype == np.int32 and np.array_equal(got[f], want[f]),
                       f"e2e oracle {name}: the engine's {f} differs from the baseline's")
            expect(np.allclose(got["dense"], want["dense"], rtol=1e-6, atol=0),
                   f"e2e oracle {name}: the engine's dense beyond rtol 1e-6 of the baseline's")
        got = {k: v.launches for k, v in kernels.items() if v.launches}
        for k, v in got.items():
            launches[k] += v
        out["launches"] = got
        return out

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

    def _flash_record(self, cfg, batch: int, seq: int, errs, kv_seq: int | None = None,
                      causal: bool = True, strided_kv: bool = False) -> dict:
        """Times of the kernel, its plain version and SDPA at one prefill
        shape (random bf16 q, k, v; ``kv_seq`` keys, ``seq`` by default).
        ``errs`` is (max abs, segment relative L2) from the checks at this
        shape; None at 32K, where the plain version runs one query head at
        a time with the kv head it reads (all 8 heads' float32 logits take
        34 GB), and at the zoo and cross phases' shapes, and the errors are
        measured here. With ``strided_kv`` k and v are [B, S, Hkv, D]
        viewed as [B, Hkv, S, D], as ``attention.context_kv`` hands a cross
        layer's over.

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
        skv = seq if kv_seq is None else kv_seq
        gen = torch.Generator(dev).manual_seed(12)
        q = torch.randn((batch, hq, seq, d), generator=gen, device=dev).to(torch.bfloat16)
        if strided_kv:
            k, v = (torch.randn((batch, skv, hkv, d), generator=gen, device=dev)
                    .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
        else:
            k, v = (torch.randn((batch, hkv, skv, d), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        per_head = errs is None
        err, rel = errs if errs else (0.0, 0.0)
        group = hq // hkv

        def head(h):  # query head h and the kv head it reads
            g = h // group
            return q[:, h:h + 1], k[:, g:g + 1], v[:, g:g + 1]

        def plain():
            if per_head:
                return [faref.mha(*head(h), causal=causal) for h in range(hq)]
            return faref.mha(q, k, v, causal=causal)

        if per_head:
            got = faops.flash_attention(q, k, v, causal=causal)
            rel_tol = FLASH_REL_L2[str(torch.bfloat16)]
            for h in range(hq):
                want = faref.mha(*head(h), causal=causal)
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
            return faops.flash_attention(q, k, v, causal=causal)

        def library():
            return sdpa(q, k, v, is_causal=causal, enable_gqa=True)

        reps = 20 if seq <= 4096 else 5
        runs = {"ms": [], "library_ms": []}
        for key, fn in (("ms", kernel), ("library_ms", library), ("library_ms", library),
                        ("ms", kernel)):
            runs[key].append(self.event_ms(fn, reps))
        ms, lib_ms = (None if None in r else sum(r) / len(r) for r in runs.values())
        plain_ms = self.event_ms(plain, reps=2 if per_head else 5)
        ops = 4 * batch * hq * seq * skv * d // (2 if causal else 1)  # causal: half
        io = (2 * batch * hq * seq + 2 * batch * hkv * skv) * d * 2
        b_ms, b_by = bound(io, ops, TENSOR_CORE_BF16_OPS_PER_S)
        backends, library_backend = self._sdpa_backends(library, reps, seq)
        rec = {
            "max_abs_err": err, "segment_rel_l2": rel, "kernel_route": faops.route(q.dtype, d),
            "ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms, "call_ms": ms,
            "ms_runs": runs["ms"], "library_ms_runs": runs["library_ms"],
            "ms_from": {"ms": "cuda_events", "plain_ms": "cuda_events",
                        "library_ms": "cuda_events"},
            "bound_ms": b_ms, "bound_by": b_by,
            "library_call": f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)",
            "library_backend": library_backend, "sdpa_backends": backends,
            "plain": "ref.mha, one query head at a time" if per_head else "ref.mha",
            "shape": f"q [{batch}, {hq}, {seq}, {d}], k/v [{batch}, {hkv}, {skv}, {d}] bf16"
                     + (" (strided head views)" if strided_kv else ""),
            "causal": causal,
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
        result["engine"] = self._engine(model, params, sparse, kernels, gated=True)
        if not self.rehearse:
            result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["seconds"] = time.perf_counter() - t_phase
        result["kernels"] = records
        return records, launches


    # -- phase 9 -------------------------------------------------------- #
    def lm_train(self) -> dict:
        """gemma-2b training from Piper's tokens: the tokens, SMOKE on the
        card against the CPU, the full-width cell, the resume contract.
        Returns {"lm_train": kernel → launches over the phase's path}.
        Prints what it measured, also when a check fails."""
        result = {"phase": "lm_train"}
        try:
            return self._lm_train(result)
        finally:
            emit(result)

    def _lm_trainer(self, cfg, device, root: Path, run: dict, sparse, total_steps: int):
        """A Trainer of ``cfg`` (remat, the chunked route) on ``device`` over
        Piper's tokens, checkpointing only at its last step."""
        from repro_torch.data import loader
        from repro_torch.launch import specs
        from repro_torch.train import optimizer, trainer

        tcfg = trainer.TrainerConfig(total_steps=total_steps, ckpt_dir=str(root),
                                     ckpt_every=1 << 30, keep_checkpoints=1,
                                     microbatches=run["microbatches"], handle_signals=False)
        batches = loader.PiperTokenBatches(sparse, cfg.vocab_size, run["batch"], run["seq"])
        opt_cfg = optimizer.AdamWConfig(schedule=optimizer.constant_schedule(LM_LR))
        return trainer.Trainer(specs.build_model(cfg, device=device), opt_cfg, tcfg, batches)

    def _spy_steps(self, t, before=None, after=None) -> list:
        """Wrap ``t.train_step``: ``before()`` and ``after()`` around each
        call, and each call's metrics into the returned list."""
        metrics, step = [], t.train_step

        def spy(params, opt, batch):
            if before:
                before()
            m = step(params, opt, batch)
            if after:
                after()
            metrics.append(m)
            return m

        t.train_step = spy
        return metrics

    def _lm_train(self, result: dict) -> dict:
        torch, np, dev = self.torch, self.np, self.dev
        from repro_torch.configs import gemma_2b
        from repro_torch.launch import train as launch_train

        gc.collect()  # an earlier phase's tensors held through a reference cycle
        if not self.rehearse:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        size = "rehearsal" if self.rehearse else "card"
        run = LM_TRAIN[size]
        cfg = gemma_2b.SMOKE if self.rehearse else gemma_2b.CONFIG
        result.update(config=cfg.name, layers=cfg.n_layers, params=cfg.param_count(), **run,
                      lr=LM_LR, allow_tf32={"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                                            "cudnn": torch.backends.cudnn.allow_tf32})
        t_phase = time.perf_counter()
        kernels = counters()

        # Piper's tokens on the card, held to the CPU path bit for bit
        rows = LM_TRAIN_ROWS[size]
        n_chunks = len(launch_train.token_chunks(rows)[1])
        reset_counters(kernels)
        self.sync()
        t0 = time.perf_counter()
        sparse = launch_train.preprocess_tokens(rows, device=str(dev))
        self.sync()
        piper_s = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels.items()}
        got = {k: v for k, v in launches.items() if v}
        tokens = result["piper_tokens"] = {"rows": rows, "chunks": n_chunks,
                                           "tokens": int(sparse.size), "seconds": piper_s,
                                           "launches": got}
        if not self.rehearse:
            want = {"decode_scan": 2 * n_chunks, "fused_genvocab": n_chunks,
                    "fused_transform": n_chunks}
            expect(got == want, f"lm_train tokens: Piper launched {got}, expected {want} (one "
                   "decode_scan a chunk in each loop, one fused_genvocab and one "
                   "fused_transform a chunk)")
        want = launch_train.preprocess_tokens(rows, device="cpu")
        expect(sparse.dtype == want.dtype and np.array_equal(sparse, want),
               "lm_train tokens: the card's tokens differ from the CPU path's")
        tokens["equal_to_cpu"] = True
        per_step = run["batch"] * run["seq"]
        expect(max(run["steps"] + 1, LM_RESUME["steps"]) * per_step <= sparse.size,
               f"lm_train tokens: {sparse.size} tokens, a window of {per_step} would wrap")

        root = ROOT / "build" / "lm_train"
        shutil.rmtree(root, ignore_errors=True)
        self._lm_smoke_agreement(sparse, root, result)
        self._lm_full(cfg, run, sparse, root, kernels, result)
        self._lm_resume(cfg, run, sparse, root, result)
        shutil.rmtree(root, ignore_errors=True)
        result["seconds"] = time.perf_counter() - t_phase
        result["launches"] = got
        return {"lm_train": launches}

    def _lm_smoke_agreement(self, sparse, root: Path, result: dict) -> None:
        """gemma-2b SMOKE through the Trainer on the card and on the CPU,
        both resuming one step-0 checkpoint made on the CPU (so the same
        weights), over the same batches (LM_SMOKE_TOL)."""
        torch, dev = self.torch, self.dev
        from repro_torch import interop
        from repro_torch.configs import gemma_2b
        from repro_torch.launch import specs
        from repro_torch.train import checkpoint, optimizer
        from repro_torch.train.tree import leaves, leaves_with_paths

        cfg, run = gemma_2b.SMOKE, LM_SMOKE_RUN
        params = specs.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        step0 = interop.lm_train_state_to_numpy(params, optimizer.adamw_init(params))
        outs = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            checkpoint.save(str(root / f"smoke_{where}"), 0, step0)
            t = self._lm_trainer(cfg, device, root / f"smoke_{where}", run, sparse, run["steps"])
            metrics = self._spy_steps(t)
            out = t.run(0)
            norms = [m["grad_norm"] for m in metrics]
            outs[where] = (out["losses"], [float(x) for x in norms], out["params"])
        (gl, gn, gp), (cl, cn, cp) = outs["card"], outs["cpu"]
        tol = LM_SMOKE_TOL
        rec = {"steps": run["steps"], "batch": run["batch"], "seq": run["seq"],
               "microbatches": run["microbatches"], "tolerance": tol, "losses_card": gl,
               "losses_cpu": cl, "loss_rel_err": [abs(a / b - 1) for a, b in zip(gl, cl)],
               "grad_norm_rel_err": [abs(a / b - 1) for a, b in zip(gn, cn)]}
        lr = LM_LR
        weights, failures = {}, []
        for (path, a), b in zip(leaves_with_paths(gp), leaves(cp)):
            d = (a.detach().cpu() - b.detach()).abs()
            key = "/".join(path)
            weights[key] = {"max_abs": float(d.max()), "flip_frac": float((d > lr).float().mean())}
            if weights[key]["flip_frac"] > tol["flip_frac"]:
                failures.append(f"{key}: {weights[key]}")
        rec["worst_weight"] = max(weights.items(), key=lambda kv: kv[1]["flip_frac"])
        result["smoke_card_vs_cpu"] = rec
        expect(len(gl) == len(cl) == run["steps"], "lm_train SMOKE: a loss is missing")
        expect(max(rec["loss_rel_err"]) <= tol["loss_rel"]
               and max(rec["grad_norm_rel_err"]) <= tol["grad_norm_rel"] and not failures,
               f"lm_train SMOKE: the card differs from the CPU beyond {tol}: loss "
               f"{rec['loss_rel_err']}, grad_norm {rec['grad_norm_rel_err']}, weights "
               + "; ".join(failures))

    def _lm_full(self, cfg, run: dict, sparse, root: Path, kernels: dict, result: dict) -> None:
        """The cell: ``cfg`` at its width and depth, remat and the chunked
        route, ``run``'s batch in microbatches, timed, profiled and
        checkpointed."""
        torch, dev = self.torch, self.dev
        from repro_torch import interop
        from repro_torch.models import lm
        from repro_torch.train import checkpoint
        from repro_torch.train.tree import leaves, leaves_with_paths

        steps, n_tok = run["steps"], run["batch"] * run["seq"]
        t = self._lm_trainer(cfg, dev, root / "full", run, sparse, steps)
        starts, ends, step_launches = [], [], []

        def mark(into):
            if not self.rehearse:
                into.append(torch.cuda.Event(enable_timing=True))
                into[-1].record()

        def before():
            reset_counters(kernels)
            mark(starts)

        def after():
            mark(ends)
            step_launches.append({k: v.launches for k, v in kernels.items() if v.launches})

        self._spy_steps(t, before, after)
        with self.tracing() as tracer:  # the Trainer's checkpoint spans
            t0 = time.perf_counter()
            out = t.run(torch.Generator(dev).manual_seed(0))
            t_end = time.perf_counter()
        spans = {e["name"]: e["dur"] / 1e6 for e in tracer.events()
                 if e["name"] in ("train/checkpoint", "train/checkpoint_wait")}
        rec = {"steps": steps, "tokens_per_step": n_tok, "seconds": t_end - t0,
               "losses": out["losses"], "host_step_s": out["step_times"],
               "launches_per_step": list(step_launches)}
        result["full"] = rec
        expect(out["final_step"] == steps and len(out["losses"]) == steps
               and all(math.isfinite(x) for x in out["losses"]),
               f"lm_train full: losses {out['losses']} after {out['final_step']} steps")
        expect(not any(step_launches), f"lm_train full: a train step launched the port's kernels "
               f"{step_launches} (the chunked route has none)")
        if starts:
            step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
            med = statistics.median(step_ms[1:])
            n_params = cfg.param_count()
            rec.update(step_ms=step_ms, ms_per_step_median=med, tokens_per_s=n_tok / (med / 1e3),
                       model_flops_share=6 * n_params * n_tok / (med / 1e3)
                       / TENSOR_CORE_BF16_OPS_PER_S,
                       model_flops={"N": n_params, "T": n_tok, "six_N_T": 6 * n_params * n_tok,
                                    "peak_flops": TENSOR_CORE_BF16_OPS_PER_S,
                                    "peak_of": "H100 SXM dense bf16", "card": self.smi},
                       peak_memory_bytes_training=torch.cuda.max_memory_allocated())

        # the final checkpoint: its bytes and seconds, restored bit for bit
        files = list((root / "full").glob("step_*/*.npy"))
        ck = rec["checkpoint"] = {"bytes": sum(f.stat().st_size for f in files),
                                  "files": len(files),
                                  "snapshot_s": spans.get("train/checkpoint"),
                                  "write_s": spans.get("train/checkpoint_wait")}
        expect(checkpoint.latest_step(str(root / "full")) == steps, "lm_train full: no checkpoint")
        t0 = time.perf_counter()
        back = checkpoint.restore(str(root / "full"), steps, interop.lm_train_state_like(cfg),
                                  device="cpu")
        ck["read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, stacked, live in (("params", back["params"], out["params"]),
                                    ("m", back["opt"]["m"], out["opt_state"]["m"]),
                                    ("v", back["opt"]["v"], out["opt_state"]["v"])):
            got = interop.lm_params_from_numpy(stacked, cfg, device=dev)
            for (path, a), b in zip(leaves_with_paths(got), leaves(live)):
                expect(torch.equal(a, b.detach()), f"lm_train full: checkpoint leaf {name}/"
                       f"{'/'.join(path)} differs after the round trip")
            del got
        expect(int(back["opt"]["step"]) == steps, "lm_train full: checkpoint step differs")
        ck["to_device_and_compare_s"] = time.perf_counter() - t0
        del back
        shutil.rmtree(root / "full")

        # one more step profiled: where its device time goes
        batch = {k: torch.as_tensor(v).to(dev) for k, v in t.batch_fn(steps).items()}
        with self.tracing():  # the optimizer's spans, in the profile
            kern, ops = self.profile(
                lambda: t.train_step(out["params"], out["opt_state"], batch), ops=True)
        if kern is not None:
            busy = sum(r["ms"] for r in kern)
            by_op = {r["name"]: r["ms"] for r in ops}
            span_ms = {r["name"]: r["total_ms"] for r in ops if r["name"].startswith("train/")}
            prof = rec["profiled_step"] = {
                "device_ms": busy, "device_launches": sum(r["count"] for r in kern),
                "top_kernels": kern[:10], "top_ops": [r for r in ops if r["ms"]][:14],
                "products_ms": sum(v for k, v in by_op.items()
                                   if k in ("aten::mm", "aten::addmm", "aten::matmul")),
                "attention_f32_einsum_ms": by_op.get("aten::bmm", 0.0),
                "clip_ms": span_ms.get("train/clip"),
                "adamw_with_clip_ms": span_ms.get("train/adamw")}
            if "ms_per_step_median" in rec:
                prof["device_busy_share"] = busy / rec["ms_per_step_median"]
            # the CE blocks of one step, timed apart at the microbatch's shape
            mb = run["batch"] // run["microbatches"]
            gen = torch.Generator(dev).manual_seed(1)
            x = torch.randn((mb, run["seq"], cfg.d_model), generator=gen, device=dev,
                            dtype=torch.bfloat16).requires_grad_()
            tgt = batch["tokens"][:mb]
            wts = torch.ones(tgt.shape, dtype=torch.float32, device=dev)
            embed = out["params"]["embed"]

            def ce():
                lm.chunked_ce(x, embed.T, tgt, wts, block=t.model.ce_block).backward()

            prof["ce_blocks_ms_per_step"] = self.event_ms(ce, reps=3, warmup=1) \
                * run["microbatches"]
            embed.grad = None
            del x
        del out, t
        gc.collect()
        if not self.rehearse:
            torch.cuda.empty_cache()

    def _lm_resume(self, cfg, run: dict, sparse, root: Path, result: dict) -> None:
        """The fault-tolerance contract at ``cfg``'s width, cut to
        LM_RESUME's depth: its steps uninterrupted against half of them, a
        checkpoint, a new Trainer and the rest. Weights and AdamW state
        equal bit for bit."""
        torch, dev = self.torch, self.dev
        from repro_torch.train.tree import leaves_with_paths

        cut = dataclasses.replace(cfg, n_superblocks=LM_RESUME["layers"])
        steps, half = LM_RESUME["steps"], LM_RESUME["steps"] // 2
        t0 = time.perf_counter()
        whole = self._lm_trainer(cut, dev, root / "resume_whole", run, sparse, steps).run(0)
        self._lm_trainer(cut, dev, root / "resume_split", run, sparse, half).run(0)
        resumed = self._lm_trainer(cut, dev, root / "resume_split", run, sparse, steps).run(0)
        rec = result["resume"] = {
            "layers": cut.n_layers, "params": cut.param_count(), "steps": steps,
            "checkpoint_at": half, "losses_whole": whole["losses"],
            "losses_resumed": resumed["losses"], "seconds": time.perf_counter() - t0}
        expect(resumed["final_step"] == steps and len(resumed["losses"]) == steps - half,
               f"lm_train resume: the second Trainer ran {resumed['final_step']} steps")
        unequal = []
        for key in ("params", "opt_state"):
            for (path, a), (_, b) in zip(leaves_with_paths(whole[key]),
                                         leaves_with_paths(resumed[key])):
                if not torch.equal(a, b):
                    unequal.append(f"{key}/{'/'.join(path)}: max |Δ| "
                                   f"{float((a.double() - b.double()).abs().max())}")
        rec["bitwise_equal"] = not unequal
        rec["unequal_leaves"] = unequal
        expect(not unequal and resumed["losses"] == whole["losses"][half:],
               "lm_train resume: the resumed run differs from the uninterrupted one: "
               + "; ".join(unequal[:6]))
        del whole, resumed
        gc.collect()
        if not self.rehearse:
            torch.cuda.empty_cache()

    # -- phase 9b ------------------------------------------------------- #
    def zoo(self, data) -> tuple[dict, dict]:
        """The MoE, SSM and hybrid families: the flash kernel's records at
        the two new shapes, SMOKE of the four architectures on the card
        against the CPU, then qwen2-moe-a2.7b, hymba-1.5b and xlstm-350m at
        full width and depth. Returns (kernel records by entry name, kernel
        → launches per prefill tag). Prints what it measured, also when a
        check fails."""
        result = {"phase": "zoo", "nvidia_smi": self.smi}
        try:
            return self._zoo(data, result)
        finally:
            emit(result)

    def _piper_tokens(self, data):
        """The prompts' source: Piper's sparse ordinals of the 5K utf8 run on
        the card, on the host."""
        from repro_torch.core import pipeline as P

        pipe = P.PiperPipeline(P.PipelineConfig(device=str(self.dev)))
        outs = list(pipe.run_stream(lambda: iter(data["utf8_chunks"])))
        return self.torch.cat([o.sparse[o.valid] for o in outs]).cpu().numpy()

    def _zoo(self, data, result: dict) -> tuple[dict, dict]:
        torch = self.torch
        from repro_torch import configs

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t_phase = time.perf_counter()
        sparse = self._piper_tokens(data)

        batch, seq = ZOO_REHEARSAL["prefill"] if self.rehearse else ZOO_PREFILL
        records = {}
        for arch in ("qwen2-moe-a2.7b", "hymba-1.5b"):
            cfg = configs.get_smoke(arch) if self.rehearse else configs.get(arch)
            records[f"flash_attention@{ZOO_MODELS[arch]}-b{batch}s{seq}"] = self._flash_record(
                cfg, batch, seq, None)
            self._free()
        result["smoke"] = {arch: self._zoo_smoke(configs.get_smoke(arch), sparse)
                           for arch in ZOO_SMOKES}
        models, launches = {}, {}
        for arch, name in ZOO_MODELS.items():
            cfg = configs.get_smoke(arch) if self.rehearse else configs.get(arch)
            tag = f"{name}-b{batch}s{seq}"
            models[arch] = {"config": cfg.name, "layers": cfg.n_layers,
                            "params": cfg.param_count(), "nvidia_smi": self.smi}
            launches[tag] = self._zoo_model(cfg, sparse, batch, seq, models[arch])
            self._free()
        result["models"] = models
        result["seconds"] = time.perf_counter() - t_phase
        result["kernels"] = records
        return records, launches

    def _free(self) -> None:
        """Drop what a model left on the card and start its peak anew."""
        gc.collect()
        if not self.rehearse:
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats()

    def _stub_inputs(self, cfg, batch: int, device, seed: int = 1) -> dict:
        """The reference launcher's stub inputs of ``cfg``'s family, normal ·
        0.1 float32 from a seeded generator on ``device``: ``frames`` [B,
        encoder_frames, d] for the audio family, ``vision`` [B, vision_tokens,
        d] for a vision LM, none otherwise."""
        torch = self.torch
        gen = torch.Generator(device).manual_seed(seed)
        key, length = (("frames", cfg.encoder_frames) if cfg.family == "audio" else
                       ("vision", cfg.vision_tokens) if cfg.vision_tokens else (None, 0))
        if key is None:
            return {}
        return {key: torch.randn((batch, length, cfg.d_model), generator=gen,
                                 device=device).mul_(0.1)}

    def _decoder_context(self, model, params, extra: dict, dtype):
        """``(decoder, context)``: the LM that decodes, and what its cross
        layers attend to: an EncDec's encoding of ``extra["frames"]``, an
        LM's ``extra["vision"]``, or None."""
        if "frames" in extra:
            return model.decoder, model.encode(params, extra["frames"], dtype)
        return model, extra.get("vision")

    def _zoo_smoke(self, cfg, sparse, name: str = "zoo") -> dict:
        """``cfg`` (a SMOKE config) on the card on the flash route and on the
        CPU on the chunked route from the same weights, float32 compute: the
        logits of a forward pass and of ZOO_SMOKE_RUN's decode steps within
        ZOO_SMOKE_REL of their largest value. An audio or vision config gets
        its stub inputs: the forward reads them, and the decode steps run
        after ``fill_context_caches``."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.launch import specs
        from repro_torch.train.tree import tree_map

        run = ZOO_SMOKE_RUN
        cpu = specs.build_model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        card = specs.build_model(cfg, attn_impl="flash", device=dev)
        card_params = tree_map(lambda t: t.to(dev), params)
        tokens = torch.from_numpy(
            loader.PiperTokenBatches(sparse, cfg.vocab_size, run["batch"], run["seq"])(2)["tokens"])
        extra = self._stub_inputs(cfg, run["batch"], "cpu")
        f32 = torch.float32
        with torch.no_grad():
            cpu_dec, cpu_ctx = self._decoder_context(cpu, params, extra, f32)
            card_dec, card_ctx = self._decoder_context(
                card, card_params, {k: t.to(dev) for k, t in extra.items()}, f32)
            want = cpu_dec.forward(params, tokens, f32, context=cpu_ctx)
            got = card_dec.forward(card_params, tokens.to(dev), f32, context=card_ctx).cpu()
        scale = float(want.abs().max())
        out = {"forward_max_abs": float((got - want).abs().max()), "scale": scale,
               "stub_inputs": sorted(extra)}
        expect(out["forward_max_abs"] <= ZOO_SMOKE_REL * scale,
               f"{name} SMOKE {cfg.name}: the card's forward differs from the CPU's by "
               f"{out['forward_max_abs']} > {ZOO_SMOKE_REL} of {scale}")
        cs = cpu_dec.init_decode_state(run["batch"], run["decode_steps"], dtype=f32)
        gs = card_dec.init_decode_state(run["batch"], run["decode_steps"], dtype=f32)
        if cpu_ctx is not None:
            cpu_dec.fill_context_caches(params, cs, cpu_ctx)
            card_dec.fill_context_caches(card_params, gs, card_ctx)
        worst = 0.0
        for pos in range(run["decode_steps"]):
            w, cs = cpu_dec.decode_step(params, tokens[:, pos], cs, pos, compute_dtype=f32)
            g, gs = card_dec.decode_step(card_params, tokens[:, pos].to(dev), gs, pos,
                                         compute_dtype=f32)
            worst = max(worst, float((g.cpu() - w).abs().max()) / float(w.abs().max()))
        out["decode_max_rel"] = worst
        expect(worst <= ZOO_SMOKE_REL, f"{name} SMOKE {cfg.name}: the card's decode steps "
               f"differ from the CPU's by {worst} > {ZOO_SMOKE_REL} of the largest logit")
        return out

    def _routing_spy(self, replay=None):
        """A context that records each MoE layer's routing (``mlp.moe_route``'s
        dict) into the list it yields. With ``replay`` (such a list from
        another run) each layer takes that run's experts, positions and keep
        masks, its gates renormalised from its own router probabilities:
        the two runs then make the same discrete choices."""
        import torch
        from repro_torch.models import mlp

        @contextlib.contextmanager
        def spying():
            real, seen = mlp.moe_route, []

            def spy(xt, params, cfg):
                r = real(xt, params, cfg)
                if replay is not None:
                    then = replay[len(seen)]
                    gates = torch.gather(r["probs"], 1, then["experts"])
                    r = dict(r, experts=then["experts"], positions=then["positions"],
                             keep=then["keep"], gates=gates / gates.sum(-1, keepdim=True))
                seen.append(r)
                return r

            mlp.moe_route = spy
            try:
                yield seen
            finally:
                mlp.moe_route = real

        return spying()

    def _zoo_model(self, cfg, sparse, batch: int, seq: int, out: dict) -> dict:
        """One full-width model: its flash-route prefill (launches counted,
        timed, profiled, held to the chunked route), the engine's traffic,
        hymba's ring wrap, the LONG_500K state. Returns the prefill's
        launches by kernel."""
        torch, dev = self.torch, self.dev
        from repro_torch.configs import shapes
        from repro_torch.data import loader
        from repro_torch.models import lm
        from repro_torch.train import steps

        kernels = counters()
        t0 = time.perf_counter()
        model = lm.LM(cfg, attn_impl="flash", device=dev)
        params = model.init(torch.Generator(dev).manual_seed(0))
        self.sync()
        out["init_s"] = time.perf_counter() - t0
        prefill = steps.make_prefill_step(model)
        tokens = torch.from_numpy(
            loader.PiperTokenBatches(sparse, cfg.vocab_size, batch, seq)(0)["tokens"]).to(dev)
        n_flash = sum(1 for s in cfg.superblock
                      if s.kind in ("attn", "hymba") and not s.window) * cfg.n_superblocks
        moe = cfg.moe is not None
        with self._routing_spy() as flash_routes:
            reset_counters(kernels)
            logits = prefill(params, {"tokens": tokens})
            self.sync()
        got = {k: v.launches for k, v in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want["flash_attention"] = 0 if self.rehearse else n_flash
        expect(got == want, f"zoo {cfg.name} prefill: launched "
               f"{ {k: v for k, v in got.items() if v} }, expected {n_flash} flash_attention")
        expect(tuple(logits.shape) == (batch, cfg.vocab_size) and
               bool(torch.isfinite(logits).all()), f"zoo {cfg.name} prefill: logits of shape "
               f"{tuple(logits.shape)}, or not finite")
        secs = self.wall_seconds(lambda: prefill(params, {"tokens": tokens}), n=2)
        med = statistics.median(secs)
        stats = {"batch": batch, "seq": seq, "seconds": secs, "ms_per_call": med * 1e3,
                 "tokens_per_s": batch * seq / med, "flash_layers": n_flash,
                 "launches": {k: v for k, v in got.items() if v}}
        if n_flash:
            self._zoo_routes(model, params, tokens, logits, flash_routes, stats)
        del flash_routes
        prof = self.profile(lambda: prefill(params, {"tokens": tokens}))
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            stats.update(device_busy_share=busy / stats["ms_per_call"],
                         profiled_call={"device_ms": busy, "top": prof[:8]})
        out["prefill"] = stats
        del logits, tokens
        if not self.rehearse:
            out["prefill_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        # the engine's bf16 logits are gated for xlstm; they are printed for
        # qwen2-moe, whose 64-token prefill drops and routes otherwise than
        # its 4-token decode steps (capacity 1.25), and for hymba, whose
        # rms-normalised Mamba outputs amplify bf16 rounding (0.65 relative
        # L2 on the H100, where float32 agrees within 1.1e-4). Every
        # model's decode is held to its prefill in float32 below, qwen2-moe
        # at a capacity of every token, so that neither side drops any.
        out["engine"] = self._engine(model, params, sparse, kernels,
                                     gated=cfg.family == "ssm")
        e = ENGINE
        prompts = loader.PiperTokenBatches(sparse, cfg.vocab_size, e["requests"],
                                           e["prompt_len"])(1)["tokens"][:e["slots"]]
        f32_model = model
        if moe:
            f32_model = lm.LM(dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)),
                attn_impl="flash", device=dev)
        f32 = self._zoo_decode_f32(f32_model, params, torch.from_numpy(prompts).to(dev),
                                   e["cache_len"])
        out["engine"].update({f"f32_decode_{k}": v for k, v in f32.items()})
        expect(f32["dropped"] == 0, f"zoo {cfg.name}: the float32 decode check dropped "
               f"{f32['dropped']} routing choices")
        expect(f32["vs_prefill_rel_l2"] <= ZOO_F32_REL_L2, f"zoo {cfg.name}: float32 decode of "
               f"{e['slots']} prompts differs from the prefill of the first by "
               f"{f32['vs_prefill_rel_l2']} > {ZOO_F32_REL_L2}")
        if cfg.family == "hybrid":
            out["ring_wrap"] = self._zoo_ring(model, params, sparse)
        if cfg.sub_quadratic:
            out["long_500k"] = self._zoo_long(model, params, sparse, shapes.LONG_500K)
        if not self.rehearse:
            out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        return got

    def _zoo_routes(self, model, params, tokens, logits, flash_routes, stats: dict) -> None:
        """The flash prefill (``logits``, bf16, routing ``flash_routes``)
        against the chunked route, the reference's. In bf16 the whole model
        (for MoE also the share of routing choices the routes agree on, the
        dropped share by layer, and the chunked route made to take the
        flash run's experts, positions and drops), and the first layer
        alone on the same input; in float32 the whole model (the kernel's
        f32 route; MoE with the flash run's routing). Gated: the first
        layer and MoE's same-routing logits within SERVE_REL_L2, float32
        within ZOO_F32_REL_L2. The free-running bf16 logits' gap is
        printed: MoE routing flips and drops, and hymba's rms-normalised
        Mamba outputs, move it past SERVE_REL_L2 with rounding alone."""
        torch, dev, cfg = self.torch, self.dev, model.cfg
        from repro_torch.models import lm
        from repro_torch.train import steps

        moe = cfg.moe is not None
        chunked = steps.make_prefill_step(lm.LM(cfg, attn_impl="chunked", device=dev))
        with self._routing_spy() as chunked_routes:
            want = chunked(params, {"tokens": tokens})
        stats.update(vs_chunked_rel_l2=self._rel_l2(logits, want),
                     vs_chunked_argmax_agree=float(
                         (logits.argmax(-1) == want.argmax(-1)).float().mean()))
        del want
        if moe:
            def agree(a_routes, b_routes):
                same = sum(int((a["experts"] == b["experts"]).sum())
                           for a, b in zip(a_routes, b_routes))
                return same / sum(a["experts"].numel() for a in a_routes)

            stats.update(routing_agree_share=agree(flash_routes, chunked_routes),
                         dropped_share=[float((~r["keep"]).float().mean())
                                        for r in flash_routes])
            with self._routing_spy(replay=flash_routes):
                same = chunked(params, {"tokens": tokens})
            stats["vs_chunked_same_routing_rel_l2"] = self._rel_l2(logits, same)
            del same
            expect(stats["vs_chunked_same_routing_rel_l2"] <= SERVE_REL_L2,
                   f"zoo {cfg.name} prefill: with the same routing, flash and chunked differ by "
                   f"{stats['vs_chunked_same_routing_rel_l2']} > {SERVE_REL_L2}")
        del chunked_routes
        # the first layer alone, the same input (the embedding) on both routes
        spec, p0 = cfg.superblock[0], params["blocks"][0][0]
        with torch.no_grad():
            x = params["embed"][tokens.to(torch.int64)].to(torch.bfloat16)
            a, _ = lm._block_forward(x, p0, spec, cfg, impl="flash")
            b, _ = lm._block_forward(x, p0, spec, cfg, impl="chunked")
        stats["first_layer_vs_chunked_rel_l2"] = self._rel_l2(a - x, b - x)
        del x, a, b
        expect(stats["first_layer_vs_chunked_rel_l2"] <= SERVE_REL_L2,
               f"zoo {cfg.name}: the first layer's update differs between flash and chunked by "
               f"{stats['first_layer_vs_chunked_rel_l2']} > {SERVE_REL_L2}")
        # float32 compute, the whole model
        f32 = torch.float32
        flash32 = steps.make_prefill_step(model)
        with self._routing_spy() as routes32:
            got32 = flash32(params, {"tokens": tokens}, compute_dtype=f32)
        with self._routing_spy(replay=routes32 if moe else None):
            want32 = chunked(params, {"tokens": tokens}, compute_dtype=f32)
        stats["f32_vs_chunked_rel_l2"] = self._rel_l2(got32, want32)
        del got32, want32, routes32
        expect(stats["f32_vs_chunked_rel_l2"] <= ZOO_F32_REL_L2,
               f"zoo {cfg.name} prefill in float32: flash and chunked differ by "
               f"{stats['f32_vs_chunked_rel_l2']} > {ZOO_F32_REL_L2}")

    def _engine(self, model, params, sparse, kernels, gated: bool) -> dict:
        """ENGINE's traffic (8 requests of Piper prompts, two waves of 4
        slots) through ServeEngine, and slot 0's request of each wave (0,
        then 4, which takes over request 0's slot and its caches and
        states) at its last prompt position against the prefill step on its
        prompt, within SERVE_REL_L2 when ``gated``; then where one more
        decode step's device time goes, and its busy share."""
        torch, dev, cfg = self.torch, self.dev, model.cfg
        from repro_torch.data import loader
        from repro_torch.serve import engine
        from repro_torch.train import steps

        e = ENGINE
        prompts = loader.PiperTokenBatches(sparse, cfg.vocab_size, e["requests"],
                                           e["prompt_len"])(1)["tokens"]
        eng = engine.ServeEngine(model, params, batch_slots=e["slots"], cache_len=e["cache_len"])
        reqs = [engine.Request(prompt=p.tolist(), max_new_tokens=e["new_tokens"])
                for p in prompts]
        seen = []  # (slot 0's position, its logits) of each step
        step = eng._step

        def spy(p, state, token, pos):
            res = step(p, state, token, pos)
            seen.append((int(eng.slot_pos[0]), res[0][0].detach().clone()))
            return res

        eng._step = spy
        for r in reqs:
            eng.submit(r)
        reset_counters(kernels)
        self.sync()
        t0 = time.perf_counter()
        eng.run_until_drained()
        self.sync()
        engine_s = time.perf_counter() - t0
        expect(all(r.done and len(r.generated) == e["new_tokens"] for r in reqs),
               f"{cfg.name} engine: generated {[len(r.generated) for r in reqs]}, expected "
               f"{e['new_tokens']} each")
        n_tokens = sum(len(r.generated) for r in reqs)
        lasts = [lg for pos, lg in seen if pos == e["prompt_len"] - 1]  # slot 0's, each wave
        expect(len(lasts) == 2, f"{cfg.name} engine: slot 0 reached its last prompt position "
               f"{len(lasts)} times, expected 2")
        prefill = steps.make_prefill_step(model)
        rels, agree = [], []
        for last, req in zip(lasts, (reqs[0], reqs[e["slots"]])):
            want = prefill(params, {"tokens": torch.tensor(req.prompt, device=dev)[None]})[0]
            rels.append(self._rel_l2(last, want))
            agree.append(bool(int(last.argmax()) == int(want.argmax())))
        rec = {**e, "steps": len(seen), "seconds": engine_s,
               "ms_per_step": engine_s / len(seen) * 1e3, "tokens_per_s": n_tokens / engine_s,
               "generated_tokens": n_tokens,
               "launches": {k: v.launches for k, v in kernels.items() if v.launches},
               "vs_prefill_rel_l2": rels[0], "wave2_vs_prefill_rel_l2": rels[1],
               "vs_prefill_gated": gated, "vs_prefill_argmax_agree": agree,
               "request0_generated": reqs[0].generated}
        if gated:
            expect(max(rels) <= SERVE_REL_L2, f"{cfg.name} engine: requests 0 and "
                   f"{e['slots']}'s logits at their last prompt position differ from the "
                   f"prefill step's by {rels} > {SERVE_REL_L2}")
        token = torch.zeros(e["slots"], dtype=torch.int32, device=dev)
        prof = self.profile(lambda: eng._step(params, eng.state, token, 0))
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            rec.update(profiled_step={"device_ms": busy,
                                      "device_launches": sum(r["count"] for r in prof),
                                      "top": prof[:8]},
                       device_busy_share=busy / rec["ms_per_step"])
        return rec

    def _zoo_decode_f32(self, model, params, tokens, cache_len: int,
                        extra: dict | None = None) -> dict:
        """``tokens [B, n]`` decoded together in float32 (caches and
        compute) into a cache of ``cache_len``: the relative L2 of row 0's
        last logits from the float32 prefill of row 0 alone; for MoE, the
        routing choices either side dropped and the share of row 0's
        (token, layer) expert sets the two agree on. ``extra`` holds the
        batch's stub inputs (``frames``, ``vision``, [B, ...]): the decode
        runs after ``fill_context_caches`` with their context, the prefill
        of row 0 reads row 0's."""
        torch = self.torch
        from repro_torch.train import steps

        f32, (b, n) = torch.float32, tokens.shape
        extra = extra or {}
        with torch.no_grad():
            decoder, context = self._decoder_context(model, params, extra, f32)
            state = decoder.init_decode_state(b, cache_len, dtype=f32)
            if context is not None:
                decoder.fill_context_caches(params, state, context)
        with torch.no_grad(), self._routing_spy() as dec:
            for pos in range(n):
                logits, state = decoder.decode_step(params, tokens[:, pos], state, pos,
                                                    compute_dtype=f32)
        del state, context
        with self._routing_spy() as pre:
            want = steps.make_prefill_step(model)(
                params, {"tokens": tokens[:1], **{k: t[:1] for k, t in extra.items()}},
                compute_dtype=f32)
        out = {"vs_prefill_rel_l2": self._rel_l2(logits[:1], want),
               "dropped": sum(int((~r["keep"]).sum()) for r in dec + pre)}
        if pre:
            layers = len(pre)
            same = [torch.equal(dec[pos * layers + i]["experts"][0].sort().values,
                                pre[i]["experts"][pos].sort().values)
                    for pos in range(n) for i in range(layers)]
            out["routing_agree_share"] = sum(same) / len(same)
        return out

    def _zoo_ring(self, model, params, sparse) -> dict:
        """One prompt longer than the sliding windows, decoded token by token
        into a cache of twice its length (every windowed layer's ring wraps;
        the global layers' caches do not), through the first superblock (8
        layers at full width, 1 global and 7 windowed: the phase's time),
        in bf16 and in float32: the last position's logits against the
        chunked route's prefill over the same tokens (bf16 within
        SERVE_REL_L2, float32 within ZOO_F32_REL_L2), and every ring's slot
        positions the last W tokens'."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.models import lm
        from repro_torch.train import steps

        cfg = dataclasses.replace(model.cfg, n_superblocks=1)
        cut = lm.LM(cfg, attn_impl="flash", device=dev)
        p1 = dict(params, blocks=params["blocks"][:1])
        n = ZOO_REHEARSAL["ring_prompt"] if self.rehearse else ZOO_RING_PROMPT
        window = max(s.window for s in cfg.superblock)
        expect(n > window, f"zoo ring: a prompt of {n} does not wrap windows of {window}")
        tokens = torch.from_numpy(
            loader.PiperTokenBatches(sparse, cfg.vocab_size, 1, n)(3)["tokens"]).to(dev)
        chunked = steps.make_prefill_step(lm.LM(cfg, attn_impl="chunked", device=dev))
        rec = {"prompt_tokens": n, "window": window, "layers": cfg.n_layers,
               "cut": f"depth {model.cfg.n_layers} -> {cfg.n_layers} (one superblock: "
                      f"{sum(1 for s in cfg.superblock if not s.window)} global, "
                      f"{sum(1 for s in cfg.superblock if s.window)} windowed layers), "
                      "the phase's time"}
        for name, dtype, tol in (("bf16", torch.bfloat16, SERVE_REL_L2),
                                 ("f32", torch.float32, ZOO_F32_REL_L2)):
            state = cut.init_decode_state(1, 2 * n, dtype=dtype)
            self.sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                for pos in range(n):
                    logits, state = cut.decode_step(p1, tokens[:, pos], state, pos,
                                                    compute_dtype=dtype)
            self.sync()
            secs = time.perf_counter() - t0
            want = chunked(p1, {"tokens": tokens}, compute_dtype=dtype)
            rel = self._rel_l2(logits, want)
            rings = [c["kv"]["slot_pos"] for sb in state for c in sb if "slot_pos" in c["kv"]]
            expect(len(rings) == sum(1 for s in cfg.superblock if s.window),
                   f"zoo ring: {len(rings)} ring caches")
            expect(all(sorted(r.tolist()) == list(range(n - r.numel(), n)) for r in rings),
                   "zoo ring: a ring's slots do not hold the last positions")
            rec[name] = {"decode_seconds": secs, "ms_per_step": secs / n * 1e3,
                         "vs_chunked_rel_l2": rel, "ring_caches": len(rings),
                         "argmax_agree": bool(int(logits.argmax()) == int(want.argmax()))}
            expect(rel <= tol, f"zoo ring ({name}): the decode's last logits differ from the "
                   f"chunked prefill's by {rel} (relative L2) > {tol}")
        return rec

    def _zoo_long(self, model, params, sparse, shape) -> dict:
        """The LONG_500K decode state (batch 1, cache 524288) and
        ZOO_LONG_STEPS decode steps at its last positions: the state's
        bytes, ms per step, finite logits."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.train.tree import leaves

        state = model.init_decode_state(shape.global_batch, shape.seq_len)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
        tokens = torch.from_numpy(loader.PiperTokenBatches(
            sparse, model.cfg.vocab_size, 1, ZOO_LONG_STEPS)(4)["tokens"]).to(dev)
        times = []
        with torch.no_grad():
            for i, pos in enumerate(range(shape.seq_len - ZOO_LONG_STEPS, shape.seq_len)):
                self.sync()
                t0 = time.perf_counter()
                logits, state = model.decode_step(params, tokens[:, i], state, pos)
                self.sync()
                times.append(time.perf_counter() - t0)
        expect(bool(torch.isfinite(logits).all()), "zoo LONG_500K: logits not finite")
        del state
        return {"seq_len": shape.seq_len, "batch": shape.global_batch, "state_bytes": n_bytes,
                "steps": ZOO_LONG_STEPS, "step_seconds": times,
                "ms_per_step": statistics.median(times) * 1e3}

    # -- phase 9c ------------------------------------------------------- #
    def cross(self, data) -> tuple[dict, dict]:
        """Cross-attention: the flash kernel's records at llama-3.2-vision's
        self and cross shapes and whisper's decoder shape, SMOKE of both
        models on the card against the CPU (forward, decode after
        fill_context_caches, one train step), then llama-3.2-vision-90b at
        full width (2 superblocks) and whisper-small at full width and
        depth. Returns (kernel records by entry name, kernel → launches per
        record tag). Prints what it measured, also when a check fails."""
        result = {"phase": "cross", "nvidia_smi": self.smi}
        try:
            return self._cross(data, result)
        finally:
            emit(result)

    def _cross_cfg(self, arch: str):
        from repro_torch import configs

        if self.rehearse:
            return configs.get_smoke(arch)
        cfg = configs.get(arch)
        if arch in CROSS_SUPERBLOCKS:
            cfg = dataclasses.replace(cfg, n_superblocks=CROSS_SUPERBLOCKS[arch])
        return cfg

    def _cross_tags(self, arch: str, batch: int, seq: int) -> dict:
        """Record tag by kind of attention layer the kernel takes here."""
        name = CROSS_MODELS[arch]
        tags = {"self": f"{name}-self-b{batch}s{seq}"}
        if arch != "whisper-small":
            tags["cross"] = f"{name}-cross-b{batch}s{seq}"
        return tags

    def _cross(self, data, result: dict) -> tuple[dict, dict]:
        torch = self.torch
        from repro_torch import configs

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t_phase = time.perf_counter()
        self._free()
        sparse = self._piper_tokens(data)
        records = {}
        for arch in CROSS_MODELS:
            cfg = self._cross_cfg(arch)
            batch, seq = CROSS_REHEARSAL["prefill"] if self.rehearse else CROSS_PREFILL[arch]
            tags = self._cross_tags(arch, batch, seq)
            records[f"flash_attention@{tags['self']}"] = self._flash_record(cfg, batch, seq, None)
            if "cross" in tags:
                records[f"flash_attention@{tags['cross']}"] = self._flash_record(
                    cfg, batch, seq, None, kv_seq=cfg.vision_tokens, causal=False,
                    strided_kv=True)
            self._free()
        result["records_s"] = time.perf_counter() - t_phase
        result["smoke"] = {arch: self._zoo_smoke(configs.get_smoke(arch), sparse, "cross")
                           for arch in CROSS_MODELS}
        result["smoke_train_step"] = {arch: self._cross_train_step(configs.get_smoke(arch),
                                                                   sparse)
                                      for arch in CROSS_MODELS}
        models, launches = {}, {}
        for arch in CROSS_MODELS:
            cfg = self._cross_cfg(arch)
            batch, seq = CROSS_REHEARSAL["prefill"] if self.rehearse else CROSS_PREFILL[arch]
            models[arch] = {"config": cfg.name, "layers": cfg.n_layers,
                            "encoder_layers": len(cfg.encoder_superblock)
                            * cfg.n_encoder_superblocks,
                            "params": cfg.param_count(), "nvidia_smi": self.smi}
            if arch in CROSS_SUPERBLOCKS and not self.rehearse:
                full = configs.get(arch)
                models[arch]["cut"] = (
                    f"depth {full.n_layers} -> {cfg.n_layers} layers ({full.n_superblocks} -> "
                    f"{cfg.n_superblocks} superblocks): {full.param_count()} parameters take "
                    f"{full.param_count() * 4} bytes in float32, more than one card holds")
            t0 = time.perf_counter()
            launches.update(self._cross_model(arch, cfg, sparse, batch, seq, models[arch]))
            models[arch]["seconds"] = time.perf_counter() - t0
            self._free()
        result["models"] = models
        result["seconds"] = time.perf_counter() - t_phase
        result["kernels"] = records
        return records, launches

    def _cross_train_step(self, cfg, sparse) -> dict:
        """One make_train_step step of ``cfg`` (a SMOKE config; LM_SMOKE_RUN's
        batch in its microbatches, the stub inputs in the batch, bf16 compute,
        the chunked route) on the card and on the CPU from the same weights
        and batch, within LM_SMOKE_TOL."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.launch import specs
        from repro_torch.train import optimizer, steps
        from repro_torch.train.tree import leaves, leaves_with_paths, tree_map

        run, tol = LM_SMOKE_RUN, LM_SMOKE_TOL
        params = specs.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card_params = tree_map(lambda t: t.to(dev, copy=True), params)  # each step updates its own
        batch = {"tokens": torch.from_numpy(loader.PiperTokenBatches(
            sparse, cfg.vocab_size, run["batch"], run["seq"])(0)["tokens"]),
            **self._stub_inputs(cfg, run["batch"], "cpu", seed=3)}
        opt_cfg = optimizer.AdamWConfig(schedule=optimizer.constant_schedule(LM_LR))
        metrics = {}
        for where, device, p in (("card", dev, card_params), ("cpu", torch.device("cpu"), params)):
            step = steps.make_train_step(specs.build_model(cfg, device=device), opt_cfg,
                                         run["microbatches"])
            m = step(p, optimizer.adamw_init(p), {k: t.to(device) for k, t in batch.items()})
            metrics[where] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        rec = {**{k: run[k] for k in ("batch", "seq", "microbatches")}, "tolerance": tol,
               "batch_keys": sorted(batch), **metrics}
        rec["loss_rel_err"], rec["grad_norm_rel_err"] = (
            abs(metrics["card"][k] / metrics["cpu"][k] - 1) for k in ("loss", "grad_norm"))
        flips = {"/".join(path): float(((a.detach().cpu() - b.detach()).abs() > LM_LR)
                                       .float().mean())
                 for (path, a), b in zip(leaves_with_paths(card_params), leaves(params))}
        rec["worst_flip_frac"] = max(flips.items(), key=lambda kv: kv[1])
        expect(rec["loss_rel_err"] <= tol["loss_rel"] and
               rec["grad_norm_rel_err"] <= tol["grad_norm_rel"] and
               rec["worst_flip_frac"][1] <= tol["flip_frac"],
               f"cross SMOKE {cfg.name}: a train step on the card differs from the CPU's beyond "
               f"{tol}: {rec}")
        return rec

    def _cross_model(self, arch: str, cfg, sparse, batch: int, seq: int, out: dict) -> dict:
        """One model at full width: its flash-route prefill (launches counted
        and split between self and cross layers, timed, profiled, held to
        the chunked route: the first layer of each kind the kernel takes in
        bf16, the first prompt through the whole model in float32), then
        float32 decode of CROSS_DECODE's prompts after fill_context_caches,
        held to their prefill, and a bf16 decode timed. Returns the
        prefill's launches by record tag."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.kernels.flash_attention import ops as faops
        from repro_torch.launch import specs
        from repro_torch.models import lm
        from repro_torch.train import steps

        kernels = counters()
        t0 = time.perf_counter()
        model = specs.build_model(cfg, attn_impl="flash", device=dev)
        params = model.init(torch.Generator(dev).manual_seed(0))
        self.sync()
        out["init_s"] = time.perf_counter() - t0
        prefill = steps.make_prefill_step(model)
        tokens = torch.from_numpy(
            loader.PiperTokenBatches(sparse, cfg.vocab_size, batch, seq)(0)["tokens"]).to(dev)
        extra = self._stub_inputs(cfg, batch, dev)
        inputs = {"tokens": tokens, **extra}
        calls, real = [], faops.flash_attention

        def spy(q, k, v, *, causal=True):
            calls.append("self" if causal else "cross")
            return real(q, k, v, causal=causal)

        faops.flash_attention = spy
        try:
            reset_counters(kernels)
            logits = prefill(params, inputs)
            self.sync()
        finally:
            faops.flash_attention = real
        got = {k: v.launches for k, v in kernels.items()}
        n_flash = 0 if self.rehearse else CROSS_FLASH_LAUNCHES[arch]
        want = dict.fromkeys(kernels, 0)
        want["flash_attention"] = n_flash
        expect(got == want, f"cross {cfg.name} prefill: launched "
               f"{ {k: v for k, v in got.items() if v} }, expected {n_flash} flash_attention "
               "and no other kernel")
        split = {kind: calls.count(kind) for kind in ("self", "cross")}
        expect(self.rehearse or sum(split.values()) == got["flash_attention"],
               f"cross {cfg.name} prefill: {split} wrapper calls for "
               f"{got['flash_attention']} launches")
        expect(tuple(logits.shape) == (batch, cfg.vocab_size) and
               bool(torch.isfinite(logits).all()), f"cross {cfg.name} prefill: logits of "
               f"shape {tuple(logits.shape)}, or not finite")
        secs = self.wall_seconds(lambda: prefill(params, inputs), n=2)
        med = statistics.median(secs)
        stats = {"batch": batch, "seq": seq, "stub_inputs": {k: list(t.shape)
                                                             for k, t in extra.items()},
                 "seconds": secs, "ms_per_call": med * 1e3, "tokens_per_s": batch * seq / med,
                 "flash_launches": split, "launches": {k: v for k, v in got.items() if v}}
        prof = self.profile(lambda: prefill(params, inputs))
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            stats.update(device_busy_share=busy / stats["ms_per_call"],
                         profiled_call={"device_ms": busy, "top": prof[:8]})
        del logits
        self._cross_routes(model, params, inputs, stats)
        out["prefill"] = stats
        if not self.rehearse:
            out["prefill_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del inputs, tokens, extra
        # decode: float32 held to the prefill, then bf16 timed
        d = CROSS_DECODE
        prompts = torch.from_numpy(loader.PiperTokenBatches(
            sparse, cfg.vocab_size, d["prompts"], d["prompt_len"])(1)["tokens"]).to(dev)
        extra = self._stub_inputs(cfg, d["prompts"], dev, seed=2)
        f32 = self._zoo_decode_f32(model, params, prompts, d["prompt_len"], extra)
        expect(f32["vs_prefill_rel_l2"] <= ZOO_F32_REL_L2, f"cross {cfg.name}: float32 decode "
               f"of {d['prompts']} prompts after fill_context_caches differs from the prefill "
               f"of the first by {f32['vs_prefill_rel_l2']} > {ZOO_F32_REL_L2}")
        with torch.no_grad():
            decoder, context = self._decoder_context(model, params, extra, torch.bfloat16)
            state = decoder.init_decode_state(d["prompts"], d["prompt_len"])
            self.sync()
            t0 = time.perf_counter()
            decoder.fill_context_caches(params, state, context)
            self.sync()
            fill_s = time.perf_counter() - t0
            step = steps.make_serve_step(model)
            times = []
            for pos in range(d["prompt_len"]):
                self.sync()
                t0 = time.perf_counter()
                step(params, state, prompts[:, pos], pos)
                self.sync()
                times.append(time.perf_counter() - t0)
            prof = self.profile(lambda: step(params, state, prompts[:, -1], d["prompt_len"] - 1))
        out["decode"] = {**d, "f32_vs_prefill_rel_l2": f32["vs_prefill_rel_l2"],
                         "fill_context_caches_ms": fill_s * 1e3,
                         "bf16_ms_per_step": statistics.median(times) * 1e3,
                         "bf16_step_ms": [t * 1e3 for t in times]}
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            out["decode"].update(device_busy_share=busy / out["decode"]["bf16_ms_per_step"],
                                 profiled_step={"device_ms": busy,
                                                "device_launches": sum(r["count"] for r in prof),
                                                "top": prof[:6]})
        if not self.rehearse:
            out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        tags = self._cross_tags(arch, batch, seq)
        return {tag: dict(got, flash_attention=0 if self.rehearse else split[kind])
                for kind, tag in tags.items()}

    def _cross_routes(self, model, params, inputs: dict, stats: dict) -> None:
        """The flash prefill against the chunked route, the reference's: in
        bf16 the first layer of each attention kind the kernel takes, on the
        same input (the embedding; the decoder's context), within
        SERVE_REL_L2; in float32 the whole model on the first prompt, within
        ZOO_F32_REL_L2."""
        torch, dev = self.torch, self.dev
        from repro_torch.kernels.flash_attention import ops as faops
        from repro_torch.launch import specs
        from repro_torch.models import lm
        from repro_torch.train import steps

        cfg = model.cfg
        tokens = inputs["tokens"]
        extra = {k: t for k, t in inputs.items() if k != "tokens"}
        layers = {}
        with torch.no_grad():
            _, context = self._decoder_context(model, params, extra, torch.bfloat16)
            x = params["embed"][tokens.to(torch.int64)].to(torch.bfloat16)
            seq, ctx_len = tokens.shape[1], context.shape[1]
            for j, spec in enumerate(cfg.superblock):
                kind = "cross" if spec.attn == "cross" else "self"
                takes = faops.takes(seq, ctx_len if kind == "cross" else seq,
                                    causal=kind == "self")
                if kind in layers or not takes:
                    continue
                p = params["blocks"][0][j]
                a, _ = lm._block_forward(x, p, spec, cfg, impl="flash", context=context)
                b, _ = lm._block_forward(x, p, spec, cfg, impl="chunked", context=context)
                layers[kind] = {"layer": j, "rel_l2": self._rel_l2(a - x, b - x)}
                del a, b
            del x, context
        stats["first_layer_vs_chunked_rel_l2"] = layers
        for kind, rec in layers.items():
            expect(rec["rel_l2"] <= SERVE_REL_L2, f"cross {cfg.name}: the first {kind} layer's "
                   f"update differs between flash and chunked by {rec['rel_l2']} > "
                   f"{SERVE_REL_L2}")
        f32 = torch.float32
        one = {k: t[:1] for k, t in inputs.items()}
        got = steps.make_prefill_step(model)(params, one, compute_dtype=f32)
        chunked = specs.build_model(cfg, attn_impl="chunked", device=dev)
        want = steps.make_prefill_step(chunked)(params, one, compute_dtype=f32)
        stats["f32_vs_chunked_rel_l2"] = self._rel_l2(got, want)
        del got, want
        expect(stats["f32_vs_chunked_rel_l2"] <= ZOO_F32_REL_L2,
               f"cross {cfg.name} prefill in float32: flash and chunked differ by "
               f"{stats['f32_vs_chunked_rel_l2']} > {ZOO_F32_REL_L2}")

    # -- phase 9d ------------------------------------------------------- #
    def sharded_train(self, data) -> dict:
        """qwen2-moe-a2.7b trained and served over a mesh on the one card:
        (a) the expert-parallel prefill, (b) the sharded Trainer against
        the unsharded one, (c) the int8 compressed mean of (b)'s shards'
        gradients, (d) the elastic resume. Returns {prefill tag: kernel →
        launches}. Prints what it measured, also when a check fails."""
        result = {"phase": "sharded_train", "nvidia_smi": self.smi}
        try:
            return self._sharded_train(data, result)
        finally:
            emit(result)

    def _train_mesh(self, mesh):
        from repro_torch.launch import mesh as mesh_lib

        shape, axes = mesh
        return mesh_lib.make_mesh(shape, axes, devices=self.dev.type)

    def _sharded_train(self, data, result: dict) -> dict:
        torch = self.torch
        from repro_torch import configs

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t_phase = time.perf_counter()
        sparse = self._piper_tokens(data)
        arch = SHARDED_TRAIN_ARCH
        cfg = configs.get(arch)
        # SMOKE at the published capacity, so that choices drop
        smoke = dataclasses.replace(configs.get_smoke(arch), moe=dataclasses.replace(
            configs.get_smoke(arch).moe, capacity_factor=cfg.moe.capacity_factor))
        if self.rehearse:
            cfg = smoke
        size = SHARDED_TRAIN_REHEARSAL if self.rehearse else SHARDED_TRAIN
        mesh = self._train_mesh(SHARDED_TRAIN_MESH)
        result.update(config=cfg.name, mesh=dict(mesh.shape), note=SHARDED_TRAIN_NOTE)
        batch, seq = size["prefill"]
        # tagged as the zoo phase's prefill of the same shape, whose flash
        # record it shares
        launches = {f"{ZOO_MODELS[arch]}-b{batch}s{seq}": self._ep_prefill(cfg, sparse, mesh, size,
                                                                            result)}
        self._free()
        cut = dataclasses.replace(cfg, n_superblocks=SHARDED_TRAIN_LAYERS)
        result["train_config"] = {"layers": cut.n_layers, "params": cut.param_count(),
                                  "reduced": f"depth {cfg.n_layers} -> {cut.n_layers}"}
        first_grads = self._ep_train(cut, sparse, mesh, size, result)
        self._compressed_mean(first_grads, result)
        del first_grads
        self._free()
        self._elastic_resume(dataclasses.replace(smoke, n_superblocks=SHARDED_TRAIN_LAYERS),
                             sparse, mesh, size, result)
        self._free()
        result["seconds"] = time.perf_counter() - t_phase
        return launches

    def _ep_prefill(self, cfg, sparse, mesh, size: dict, result: dict) -> dict:
        """(a): the flash-route prefill at full width and depth under
        use_mesh (launches counted, timed, profiled, drops per layer against
        the dense route), then its first layers in float32 against the dense
        path per data shard. Returns the prefill's launches by kernel."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.distributed import sharding
        from repro_torch.models import lm
        from repro_torch.train import steps

        kernels = counters()
        rec = result["ep_prefill"] = {"layers": cfg.n_layers, "params": cfg.param_count()}
        t0 = time.perf_counter()
        model = lm.LM(cfg, attn_impl="flash", device=dev)
        params = model.init(torch.Generator(dev).manual_seed(0))
        self.sync()
        rec["init_s"] = time.perf_counter() - t0
        prefill = steps.make_prefill_step(model)
        batch, seq = size["prefill"]
        tokens = torch.from_numpy(
            loader.PiperTokenBatches(sparse, cfg.vocab_size, batch, seq)(0)["tokens"]).to(dev)

        def ep_prefill():
            with sharding.use_mesh(mesh):
                return prefill(params, {"tokens": tokens})

        n_flash = cfg.n_layers
        with self._routing_spy() as ep_routes:
            reset_counters(kernels)
            logits = ep_prefill()
            self.sync()
        got = {k: v.launches for k, v in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want["flash_attention"] = 0 if self.rehearse else n_flash
        rec["launches"] = {k: v for k, v in got.items() if v}
        expect(got == want, f"sharded_train EP prefill: launched {rec['launches']}, expected "
               f"{n_flash} flash_attention")
        expect(tuple(logits.shape) == (batch, cfg.vocab_size) and
               bool(torch.isfinite(logits).all()), "sharded_train EP prefill: logits of shape "
               f"{tuple(logits.shape)}, or not finite")
        n_data = mesh.shape["data"]
        expect(len(ep_routes) == cfg.n_layers * n_data, f"sharded_train EP prefill: "
               f"{len(ep_routes)} routings, expected one per layer and data shard")
        rec["drops_per_layer_ep"] = [
            sum(int((~r["keep"]).sum()) for r in ep_routes[i * n_data:(i + 1) * n_data])
            for i in range(cfg.n_layers)]
        del ep_routes
        with self._routing_spy() as dense_routes, torch.no_grad():
            prefill(params, {"tokens": tokens})
            rec["drops_per_layer_dense"] = [int((~r["keep"]).sum()) for r in dense_routes]
        del dense_routes
        secs = self.wall_seconds(ep_prefill, n=2)
        med = statistics.median(secs)
        rec.update(batch=batch, seq=seq, experts_per_rank=cfg.moe.n_experts // mesh.shape["model"],
                   seconds=secs, ms_per_call=med * 1e3, tokens_per_s=batch * seq / med)
        prof = self.profile(ep_prefill)
        if prof is not None:
            busy = sum(r["ms"] for r in prof)
            rec.update(device_busy_share=busy / rec["ms_per_call"],
                       profiled_call={"device_ms": busy, "top": prof[:8]})
        if not self.rehearse:
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del logits
        # float32, the first layers: the EP path against the dense path run
        # on each data shard's rows
        cut = dataclasses.replace(cfg, n_superblocks=SHARDED_TRAIN_LAYERS)
        head = lm.LM(cut, attn_impl="flash", device=dev)
        sub = dict(params, blocks=params["blocks"][:SHARDED_TRAIN_LAYERS])
        with torch.no_grad():
            with sharding.use_mesh(mesh), self._routing_spy() as routes:
                x_ep, aux_ep = head.trunk(sub, tokens, torch.float32)
            parts = [head.trunk(sub, t, torch.float32) for t in tokens.chunk(n_data)]
        x_dense = torch.cat([x for x, _ in parts])
        aux_dense = torch.stack([a for _, a in parts]).mean()
        f32 = {"layers": SHARDED_TRAIN_LAYERS, "rel_l2": self._rel_l2(x_ep, x_dense),
               "aux_ep": float(aux_ep), "aux_dense_mean": float(aux_dense),
               "aux_rel_err": abs(float(aux_ep) / float(aux_dense) - 1),
               "drops": sum(int((~r["keep"]).sum()) for r in routes)}
        rec["f32_vs_dense_per_shard"] = f32
        del routes, parts, x_ep, x_dense
        expect(f32["drops"] > 0, "sharded_train EP float32 check: no capacity drop to check")
        expect(f32["rel_l2"] <= SHARDED_EP_F32_REL_L2 and f32["aux_rel_err"] <= SHARDED_EP_AUX_REL,
               f"sharded_train EP float32: {f32} beyond {SHARDED_EP_F32_REL_L2} / "
               f"{SHARDED_EP_AUX_REL}")
        return got

    def _sharded_trainer(self, cfg, sparse, size: dict, root: Path, mesh=None, steps=None,
                         save: bool = True):
        """A Trainer of ``cfg`` (remat, the chunked route, LM_LR) over
        Piper's tokens, checkpointing at its last step only (not at all
        without ``save``: (d) holds the checkpoints), sharded by
        param_shardings over ``mesh`` when one is given."""
        from repro_torch.data import loader
        from repro_torch.distributed import sharding
        from repro_torch.launch import specs
        from repro_torch.models import lm
        from repro_torch.train import optimizer, trainer

        tcfg = trainer.TrainerConfig(total_steps=steps or size["steps"], ckpt_dir=str(root),
                                     ckpt_every=1 << 30, keep_checkpoints=1,
                                     handle_signals=False)
        batches = loader.PiperTokenBatches(sparse, cfg.vocab_size, size["batch"], size["seq"])
        opt_cfg = optimizer.AdamWConfig(schedule=optimizer.constant_schedule(LM_LR))
        shardings = None
        if mesh is not None:
            skeleton = lm.LM(cfg, device="meta").init()
            shardings = (sharding.param_shardings(skeleton, mesh),
                         sharding.param_shardings(optimizer.adamw_init(skeleton), mesh),
                         sharding.NamedSharding(mesh, sharding.batch_spec(mesh)))
        t = trainer.Trainer(specs.build_model(cfg, device=self.dev), opt_cfg, tcfg, batches,
                            mesh=mesh, shardings=shardings)
        if not save:
            t._save = lambda *args, **kw: None
        return t

    def _agreement(self, got: dict, want: dict, what: str) -> dict:
        """Two runs' losses, grad norms and final weights held to
        LM_SMOKE_TOL (``got`` and ``want``: {"losses", "grad_norms",
        "params"})."""
        from repro_torch.train.tree import leaves, leaves_with_paths

        tol = LM_SMOKE_TOL
        rec = {"tolerance": tol, "losses": got["losses"], "losses_want": want["losses"],
               "grad_norms": got["grad_norms"], "grad_norms_want": want["grad_norms"],
               "loss_rel_err": [abs(a / b - 1) for a, b in zip(got["losses"], want["losses"])],
               "grad_norm_rel_err": [abs(a / b - 1) for a, b in zip(got["grad_norms"],
                                                                    want["grad_norms"])]}
        worst, failures = (None, -1.0), []
        for (path, a), b in zip(leaves_with_paths(got["params"]), leaves(want["params"])):
            d = (a.detach() - b.detach().to(a.device)).abs()
            flip = float((d > LM_LR).float().mean())
            if flip > worst[1]:
                worst = ("/".join(path), flip, float(d.max()))
            if flip > tol["flip_frac"]:
                failures.append(f"{'/'.join(path)}: {flip}")
        rec["worst_weight"] = {"leaf": worst[0], "flip_frac": worst[1], "max_abs": worst[2]}
        expect(len(got["losses"]) == len(want["losses"]) > 0, f"{what}: a loss is missing")
        expect(max(rec["loss_rel_err"]) <= tol["loss_rel"]
               and max(rec["grad_norm_rel_err"]) <= tol["grad_norm_rel"] and not failures,
               f"{what}: beyond {tol}: loss {rec['loss_rel_err']}, grad_norm "
               f"{rec['grad_norm_rel_err']}, weights " + "; ".join(failures))
        return rec

    def _ep_train(self, cfg, sparse, mesh, size: dict, result: dict) -> list:
        """(b): the unsharded Trainer, then Trainer(mesh, shardings), each
        from the same seeded init and batches under use_mesh (EP with
        autograd), held to each other; peaks and ms per step. Returns the
        two data shards' first-step gradients of (c), each a list over the
        parameters."""
        torch = self.torch
        from repro_torch.distributed import sharding
        from repro_torch.train.tree import tree_map

        root = ROOT / "build" / "sharded_train"
        shutil.rmtree(root, ignore_errors=True)
        runs = {}
        for name, m in (("unsharded", None), ("sharded", mesh)):
            self._free()
            t = self._sharded_trainer(cfg, sparse, size, root / name, mesh=m, save=False)
            metrics = self._spy_steps(t)
            with sharding.use_mesh(mesh):
                out = t.run(0)
            self.sync()
            runs[name] = {"losses": out["losses"],
                          "grad_norms": [float(x["grad_norm"]) for x in metrics],
                          "params": out["params"], "step_ms": [x * 1e3 for x in out["step_times"]],
                          "peak_memory_bytes": (None if self.rehearse
                                                else torch.cuda.max_memory_allocated())}
            if m is None:  # off the card while the sharded run measures its peak
                runs[name]["params"] = tree_map(lambda x: x.detach().cpu(), out["params"])
            del t, out, metrics
        sharded, plain = runs["sharded"], runs["unsharded"]
        rec = self._agreement(sharded, plain, "sharded_train (b)")
        rec.update({f"{k}_{name}": runs[name][k] for name in runs
                    for k in ("step_ms", "peak_memory_bytes")})
        result["trainer"] = rec
        if not self.rehearse:
            expect(sharded["peak_memory_bytes"] <= SHARDED_TRAIN_PEAK * plain["peak_memory_bytes"],
                   f"sharded_train (b): the sharded Trainer's peak {sharded['peak_memory_bytes']} "
                   f"is over {SHARDED_TRAIN_PEAK} x the unsharded {plain['peak_memory_bytes']}")
        del runs, sharded, plain
        return self._shard_gradients(cfg, sparse, mesh, size)

    def _shard_gradients(self, cfg, sparse, mesh, size: dict) -> list:
        """Each data shard's gradient at the first step (the seeded init,
        batch 0): of the loss over its rows alone, as a data-parallel rank
        computes it (the dense MoE path over one shard's rows is the
        expert-parallel path's). Their mean is the step's gradient."""
        torch, dev = self.torch, self.dev
        from repro_torch.data import loader
        from repro_torch.launch import specs
        from repro_torch.train import steps
        from repro_torch.train.tree import leaves

        self._free()
        model = specs.build_model(cfg, device=dev)
        tree = steps.trainable(model.init(torch.Generator(dev).manual_seed(0)))
        tokens = torch.from_numpy(loader.PiperTokenBatches(
            sparse, cfg.vocab_size, size["batch"], size["seq"])(0)["tokens"]).to(dev)
        return [list(torch.autograd.grad(model.loss(tree, part), leaves(tree)))
                for part in tokens.chunk(mesh.shape["data"])]

    def _compressed_mean(self, grads: list, result: dict) -> None:
        """(c): compressed_psum_mean over the shards' gradients, stacked
        [2, ...] leaf by leaf: per element within scale / 2 (and float32's
        rounding of the two means) of the plain mean, the residual y − Q⁻¹(Q(y))
        exactly; payload bytes against float32's."""
        torch = self.torch
        from repro_torch.distributed import compression

        stacked = []
        while grads[0]:
            stacked.append(torch.stack([g.pop(0) for g in grads]))
        err = compression.error_state_init(stacked)
        self.sync()
        t0 = time.perf_counter()
        mean, new_err = compression.compressed_psum_mean(stacked, err)
        self.sync()
        rec = {"leaves": len(stacked), "elements": sum(s[0].numel() for s in stacked),
               "shards": len(grads), "seconds": time.perf_counter() - t0}
        worst, exact = 0.0, True
        eps = float(torch.finfo(torch.float32).eps)
        for y, m, e in zip(stacked, mean, new_err):
            amax = y.abs().max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
            exact &= bool(torch.equal(e, y - q.to(torch.float32) * scale))
            gap = float((m - y.mean(0)).abs().max())
            worst = max(worst, gap / float(scale))
            expect(gap <= float(scale) / 2 + 4 * eps * float(amax),
                   f"sharded_train (c): a compressed mean is {gap} from the plain mean, over "
                   f"scale / 2 = {float(scale) / 2}")
        rec.update(worst_gap_over_scale=worst, residual_exact=exact,
                   payload_bytes=rec["elements"] + 4 * rec["leaves"],
                   f32_bytes=4 * rec["elements"])
        rec["payload_ratio"] = rec["payload_bytes"] / rec["f32_bytes"]
        result["compressed_mean"] = rec
        expect(exact, "sharded_train (c): a residual is not y - dequant exactly")

    def _elastic_resume(self, cfg, sparse, mesh, size: dict, result: dict) -> None:
        """(d): two steps of ``cfg`` under ``mesh`` with a checkpoint (no
        use_mesh: the MoE layers take the dense path); Trainers on
        SHARDED_TRAIN_RESUME_MESH and with no mesh resume it: each
        restored state equal to the writer's bit for bit, their first
        resumed step's loss equal bit for bit, the continuations held to
        each other at LM_SMOKE_TOL (and whether they are equal bit for bit
        recorded)."""
        torch = self.torch
        from repro_torch.train.tree import leaves

        root = ROOT / "build" / "sharded_train" / "resume"
        shutil.rmtree(root, ignore_errors=True)
        half, steps = size["resume_at"], size["resume_steps"]
        rec = result["elastic_resume"] = {"config": cfg.name, "layers": cfg.n_layers,
                                          "checkpoint_mesh": dict(mesh.shape), "at": half,
                                          "steps": steps}
        t_resume = time.perf_counter()
        try:
            t0 = time.perf_counter()
            first = self._sharded_trainer(cfg, sparse, size, root / "written", mesh=mesh,
                                          steps=half).run(0)
            rec["write_s"] = time.perf_counter() - t0
            written = leaves((first["params"], first["opt_state"]))
            del first
            runs = {}
            for name, m in (("other_mesh", self._train_mesh(SHARDED_TRAIN_RESUME_MESH)),
                            ("no_mesh", None)):
                d = root / name
                d.mkdir(parents=True)
                shutil.copytree(root / "written" / f"step_{half:08d}", d / f"step_{half:08d}",
                                copy_function=os.link)
                t = self._sharded_trainer(cfg, sparse, size, d, mesh=m, steps=steps, save=False)
                restore = t._restore

                def restored(step, restore=restore, name=name):
                    t0 = time.perf_counter()
                    params, opt = restore(step)
                    rec[f"restore_s_{name}"] = time.perf_counter() - t0
                    rec[f"restored_bitwise_{name}"] = all(
                        torch.equal(a, b) for a, b in zip(leaves((params, opt)), written))
                    return params, opt

                t._restore = restored
                metrics = self._spy_steps(t)
                out = t.run(0)
                expect(rec[f"restored_bitwise_{name}"], f"sharded_train (d): the state restored "
                       f"{name.replace('_', ' ')} differs from the writer's")
                expect(out["final_step"] == steps and len(out["losses"]) == steps - half,
                       f"sharded_train (d): the {name} Trainer ran to {out['final_step']}")
                runs[name] = {"losses": out["losses"],
                              "grad_norms": [float(x["grad_norm"]) for x in metrics],
                              "params": out["params"]}
                del t, out, metrics
            rec["first_resumed_loss_bitwise"] = (runs["other_mesh"]["losses"][0]
                                                 == runs["no_mesh"]["losses"][0])
            expect(rec["first_resumed_loss_bitwise"], "sharded_train (d): the first resumed "
                   f"step's loss differs: {runs['other_mesh']['losses'][0]} on "
                   f"{SHARDED_TRAIN_RESUME_MESH[0]}, {runs['no_mesh']['losses'][0]} with no mesh")
            rec["other_vs_no_mesh"] = self._agreement(runs["other_mesh"], runs["no_mesh"],
                                                      "sharded_train (d)")
            rec["continuations_bitwise"] = (
                runs["other_mesh"]["losses"] == runs["no_mesh"]["losses"]
                and all(torch.equal(a, b) for a, b in zip(leaves(runs["other_mesh"]["params"]),
                                                          leaves(runs["no_mesh"]["params"]))))
        finally:
            shutil.rmtree(root, ignore_errors=True)
            rec["seconds"] = time.perf_counter() - t_resume

    # -- phase 10 ------------------------------------------------------- #
    def analysis(self) -> dict:
        """The static gate (repro_torch.analysis) on the card: the whole
        --strict gate in-process; then the audited routes at CRITEO
        (fused with the bytes-in route, the count plane, use_kernels on the
        decoded route) once each under the launch audit and sync debug mode, each
        call's kernel entries held exactly to the launch counters and to the
        device kernels the profiler sees; every library's launch config
        against its declaration; the ptxas table. Returns the audited
        routes' launches under "5K"."""
        torch = self.torch
        from repro_torch.analysis import __main__ as gate
        from repro_torch.analysis import kernelcheck, launch_audit
        from repro_torch.core import plan as plan_lib
        from repro_torch.core import plan_compiler
        from repro_torch.core import schema as schema_lib
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        report_path = ROOT / "build" / "analysis_report.json"
        report_path.parent.mkdir(parents=True, exist_ok=True)
        rc = gate.main(["--strict", "--device", str(self.dev), "--json", str(report_path)])
        report = json.loads(report_path.read_text())
        gate_s = time.perf_counter() - t0
        expect(rc == 0 and not report["new"] and not report["stale"],
               f"analysis: the --strict gate failed: new {report['new']}, stale {report['stale']}")
        kc = report["stats"]["kernelcheck"]
        if not self.rehearse:
            configs = kc["launch_configs"]
            expect(all(r["equal"] for r in configs), "analysis: a launch_accounting differs from "
                   "its library's launch_config")
            libs = {r["library"] for r in configs}
            expect(libs == set(_build.SOURCES), f"analysis: launch configs compared for {libs}")
            table = kc["ptxas"]
            emit({"phase": "analysis_ptxas", "what": "registers, static shared bytes and spill "
                  "bytes per kernel (nvcc -Xptxas -v)", "nvidia_smi": self.smi, "ptxas": table})
            flash = [u for lib in table.values() for n, u in lib.items()
                     if kernelcheck.FLASH_WGMMA_D256 in n]
            expect(flash and all(u["spill_stores"] == u["spill_loads"] == 0 for u in flash),
                   f"analysis: the D 256 wgmma kernel spills ({flash})")
        else:
            expect(len(report["stats"]["skipped"]) == 3, "analysis: card-only checks ran on the CPU")

        # the audited routes, each call held three ways
        _, threads = kernelcheck.audit_sources(kernelcheck.read_sources(str(ROOT)))
        hand = re.compile(r"(?:::|\s)(?:" + "|".join(sorted(threads)) + r")[<(]")
        kernels = counters()
        schema = schema_lib.CRITEO
        routings = {"fused": {"fused": True, "fused_vocab": True, "fused_decode": True},
                    "counts": {"fused": True, "fused_vocab": True, "track_counts": True},
                    "kernels": {"use_kernels": True}}
        launches = {name: 0 for name in kernels}
        routes = {}
        for routing, hints in routings.items():
            compiled = plan_compiler.compile_plan(plan_lib.criteo_default(schema), schema,
                                                  device=self.dev, **hints)
            inputs = launch_audit.route_inputs(compiled, 4096)
            inputs.max_rows = MAX_ROWS
            calls = launch_audit.hot_path_calls(compiled, inputs)
            if routing == "kernels":  # the decoded route: decode, then each loop's kernels
                both = launch_audit.route_calls(compiled, inputs)
                calls.update(decode_vocab=both["decode_vocab"], decode_xform=both["decode_xform"])
            found, traced = launch_audit.audit_calls(calls, self.dev, context=routing)
            expect(not found, f"analysis: {routing}: {[f.render() for f in found]}")
            for name, call in calls.items():
                entries = dict(traced[name].entries)
                reset_counters(kernels)
                call()
                self.sync()
                got = {k: v.launches for k, v in kernels.items() if v.launches}
                for k, v in got.items():
                    launches[k] += v
                rec = {"entries": entries, "launches": got}
                if not self.rehearse:
                    expect(sum(got.values()) == sum(entries.values()),
                           f"analysis: {routing}/{name}: entries {entries}, launches {got}")
                    for entry, n in entries.items():
                        made = sum(k.launches for k in _build.ENTRIES[entry])
                        expect(made == n, f"analysis: {routing}/{name}: {entry} x{n} launched "
                               f"{made}")
                    seen = device_kernels(torch, call, calls=5)
                    on_card = sum(n for k, n in seen.items() if hand.search(" " + k)) / 5
                    rec["device_kernels"] = on_card
                    expect(on_card == sum(entries.values()),
                           f"analysis: {routing}/{name}: {on_card} hand kernels a call on the "
                           f"card, {entries} entries")
                routes[f"{routing}/{name}"] = rec
        seconds = time.perf_counter() - t0
        emit({"phase": "analysis", "gate_seconds": gate_s, "seconds": seconds,
              "nvidia_smi": self.smi, "findings": report["summary"],
              "skipped": report["stats"]["skipped"],
              "dispatches": report["stats"].get("dispatches"), "routes": routes,
              "launch_configs_compared": len(kc.get("launch_configs", []))})
        return {"5K": launches}


def make_data(np, rows: dict) -> dict:
    """The main path's feeds, made from fixed seeds."""
    from repro_torch.data import synth

    rows_utf8, rows_binary = rows["utf8"], rows["binary"]
    t0 = time.perf_counter()
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows_utf8, seed=0))
    chunks = list(synth.chunk_stream(buf, CHUNK_BYTES))
    binary = synth.generate_binary(synth.SynthConfig(rows=rows_binary, seed=1))
    binary = {k: binary[k] for k in ("label", "dense", "sparse")}
    spans = synth.row_spans(buf)
    emit({"phase": "data", "utf8_rows": rows_utf8, "utf8_bytes": int(buf.size),
          "utf8_chunks": len(chunks), "binary_rows": rows_binary,
          "seconds": time.perf_counter() - t0})
    return {"utf8_buf": buf, "utf8_chunks": chunks, "utf8_rows": rows_utf8, "utf8_spans": spans,
            "binary": binary, "binary_rows": rows_binary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernels,golden,main,sharded,stream,train,serve,e2e,lm_train,"
                            "zoo,cross,sharded_train,analysis")
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
    stream_launches = e2e_launches = lm_launches = sharded_launches = None
    analysis_launches = zoo_launches = cross_launches = sharded_train_launches = None
    rows = REHEARSAL_ROWS if args.rehearse else ROWS
    data = (make_data(np, rows)
            if phases & {"kernels", "main", "sharded", "stream", "train", "serve", "e2e", "zoo",
                         "cross", "sharded_train"}
            else None)
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
    if "sharded" in phases:
        ranges = REHEARSAL_RANGES if args.rehearse else RANGES
        sharded_launches = {tag: smoke.sharded(data, tag, vr) for tag, vr in ranges.items()}
        if not args.rehearse:
            for name in SHARDED_KERNELS:
                expect(all(m[name] > 0 for m in sharded_launches.values()),
                       f"sharded path: {name} was not launched at every range")
    if "stream" in phases:
        ranges = REHEARSAL_RANGES if args.rehearse else RANGES
        stream_launches = {tag: smoke.stream(data, tag, vr) for tag, vr in ranges.items()}
        if not args.rehearse:
            for name in STREAM_KERNELS:
                expect(sum(m[name] for m in stream_launches.values()) > 0,
                       f"stream path: {name} was never launched")
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

    if "e2e" in phases:
        e2e_launches = {tag: smoke.e2e(data, tag) for tag in RANGES}
        if not args.rehearse:
            for name in E2E_KERNELS:
                expect(all(m[name] > 0 for m in e2e_launches.values()),
                       f"e2e path: {name} was not launched at every range")

    if "lm_train" in phases:
        lm_launches = smoke.lm_train()
        if not args.rehearse:
            for name in LM_TRAIN_KERNELS:
                expect(lm_launches["lm_train"][name] > 0, f"lm_train path: {name} was never "
                       "launched")

    if "zoo" in phases:
        zoo_records, zoo_launches = smoke.zoo(data)
        records.update(zoo_records)
        if not args.rehearse:
            for name in ZOO_KERNELS:
                expect(all(m[name] > 0 for t, m in zoo_launches.items()
                           if not t.startswith("xlstm")),
                       f"zoo path: {name} was not launched in every qwen2-moe and hymba prefill")

    if "cross" in phases:
        cross_records, cross_launches = smoke.cross(data)
        records.update(cross_records)
        if not args.rehearse:
            for name in CROSS_KERNELS:
                expect(all(m[name] > 0 for m in cross_launches.values()),
                       f"cross path: {name} was not launched by every layer kind of a prefill")

    if "sharded_train" in phases:
        sharded_train_launches = smoke.sharded_train(data)
        if not args.rehearse:
            for name in SHARDED_TRAIN_KERNELS:
                expect(all(m[name] > 0 for m in sharded_train_launches.values()),
                       f"sharded_train path: {name} was not launched in the EP prefill")

    if "analysis" in phases:
        analysis_launches = smoke.analysis()
        if not args.rehearse:
            for name in ANALYSIS_KERNELS:
                expect(analysis_launches["5K"][name] > 0, f"analysis path: {name} was never "
                       "launched")

    # launches on the paths: the main, sharded, stream, train and e2e phases'
    # per range, the serve, zoo and sharded_train phases' per prefill, the
    # cross phase's per prefill and layer kind, the lm_train phase's, the
    # analysis phase's audited routes
    paths = [m for m in (main_launches, sharded_launches, stream_launches, train_launches,
                         serve_launches, e2e_launches, lm_launches, zoo_launches,
                         cross_launches, sharded_train_launches, analysis_launches)
             if m is not None]
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
                                   "fresh_ms", "binary", "f32", "stages",
                                   "cuda_launches_per_call", "table_sectors", "bound_ms_by_sectors",
                                   "kernels_per_call")
               if k in rec},
            "launch_floor_ms": rec.get("launch_floor_ms", smoke.floor_ms),
            "on_main_path": name in (PATH_KERNELS + SHARDED_KERNELS + STREAM_KERNELS
                                     + TRAIN_KERNELS + SERVE_KERNELS + E2E_KERNELS
                                     + LM_TRAIN_KERNELS + ZOO_KERNELS + CROSS_KERNELS
                                     + SHARDED_TRAIN_KERNELS + ANALYSIS_KERNELS),
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
