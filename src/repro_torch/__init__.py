"""PyTorch + CUDA port of the PIPER two-loop tabular preprocessing engine.

A second package beside the JAX reference (``src/repro``), with the same
layout and names so each counterpart is easy to find:

  * ``core/``    — schema, the vocabulary engine, the stateless operators
    and the two-loop ``PiperPipeline``;
  * ``kernels/`` — hand-written CUDA kernels for Hopper (``csrc/*.cu``),
    each beside a plain PyTorch version of the same function (``ref.py``);
  * ``data/``    — synthetic Criteo-format data and the binary chunk feed;
  * ``interop``  — carrying loop-① state and vocabularies across packages.

The package imports ``torch`` and numpy only. Its entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU; on the CPU
every kernel wrapper takes its plain version.
"""
