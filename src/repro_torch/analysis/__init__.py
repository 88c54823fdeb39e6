"""Static plan/kernel/concurrency verifier — ``python -m repro_torch.analysis``.

Counterpart of ``repro/analysis``, over the port. Four passes:

  planlint     interval abstract interpretation over ``PreprocPlan`` op
               chains (overflow, index bounds, ordering hazards, dead or
               no-op stages) — :mod:`repro_torch.analysis.planlint`
  kernelcheck  the compiled plan's routes and declared launches against
               sm_90's limits and the kernels the dispatches call, an
               audit of the CUDA sources' launches, and on the card the
               launch configs the libraries report and their ptxas logs —
               :mod:`repro_torch.analysis.kernelcheck`
  launches     hot-path dispatch counting with hand-kernel entries as one,
               host synchronisation, in-place train steps —
               :mod:`repro_torch.analysis.launch_audit`
  locklint     declared lock discipline over every module of the port
               that holds a lock — :mod:`repro_torch.analysis.locklint`

Findings are :class:`~repro_torch.analysis.findings.Finding` records (rule
id, severity, location); reviewed residual findings live in
``analysis/torch_baseline.json`` and ``--strict`` fails on anything outside
it. The rule table, with each reference rule's counterpart, is in
README.md.
"""

from repro_torch.analysis.findings import (  # noqa: F401
    Finding,
    diff_baseline,
    dump_findings,
    load_baseline,
)
