"""PyTorch + CUDA port of the PIPER two-loop tabular preprocessing engine,
and of the DLRM training it feeds.

A second package beside the JAX reference (``src/repro``), with the same
layout and names so each counterpart is easy to find:

  * ``core/``    — schema, the vocabulary engine, the stateless operators,
    the preprocessing-plan IR and its compiler, and the two-loop
    ``PiperPipeline`` that runs a compiled plan;
  * ``kernels/`` — hand-written CUDA kernels for Hopper (``csrc/*.cu``),
    each beside a plain PyTorch version of the same function (``ref.py``);
  * ``data/``    — synthetic Criteo-format data and the binary chunk feed;
  * ``configs/``, ``models/``, ``train/`` — the DLRM that Piper's output
    trains (the paper's end-to-end system): its workload configs, the
    model, the optimizers, the train step, batch assembly and checkpoints;
  * ``interop``  — carrying loop-① state, vocabularies, plans, DLRM
    weights and optimizer state across packages.

The package imports ``torch`` and numpy only. Its entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU; on the CPU
every kernel wrapper takes its plain version.
"""
