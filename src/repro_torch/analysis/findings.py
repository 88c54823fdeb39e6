"""Finding record + baseline machinery shared by every analysis pass.

Counterpart of ``repro/analysis/findings.py``, kept as the port's own copy
(the port imports nothing of the JAX package).

A :class:`Finding` is one rule violation: rule id, severity, the pass
that produced it, a repo-relative location, and a short stable ``obj``
(the symbol or plan column the finding is *about*). The baseline file
(``analysis/torch_baseline.json``) stores reviewed residual findings keyed by
``(rule, file, obj)`` — deliberately NOT by line number, so unrelated
edits that shift lines do not churn the baseline. ``--strict`` (the CI
gate) fails on any finding outside the baseline and on any stale
baseline entry the code no longer produces.

Severities:
  ``error``    statically-provable defect (overflow, race, route or launch
               contradiction, hot-path host sync) — gates CI
  ``warning``  suspicious but conceivably intentional (no-op stage,
               range mismatch, a step that reallocates) — gates CI, baselinable
  ``info``     advisory (dispatch counts, dead state) — never gates
"""

from __future__ import annotations

import dataclasses
import json

SEVERITIES = ("error", "warning", "info")
# severities that fail the --strict gate when not baselined
GATING = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # e.g. "PL101" — see the rule table in README.md
    severity: str    # "error" | "warning" | "info"
    pass_name: str   # "planlint" | "kernelcheck" | "launches" | "locklint"
    file: str        # repo-relative path the finding anchors to
    line: int        # 1-based; 0 = whole-file / synthetic location
    obj: str         # stable symbol/context (baseline key component)
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def key(self) -> tuple[str, str, str]:
        """Baseline identity — line-number-free so edits don't churn it."""
        return (self.rule, self.file, self.obj)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{self.rule} {self.severity:7s} {loc} [{self.obj}] {self.message}"


def dump_findings(findings: list[Finding], extra: dict | None = None) -> dict:
    """The machine-readable report shape (``--json`` / baseline files)."""
    by_sev = {s: sum(1 for f in findings if f.severity == s) for s in SEVERITIES}
    out = {
        "version": 1,
        "findings": [f.to_dict() for f in findings],
        "summary": {"total": len(findings), **by_sev},
    }
    if extra:
        out.update(extra)
    return out


def load_baseline(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data.get("findings", [])


def diff_baseline(
    findings: list[Finding], baseline: list[dict]
) -> tuple[list[Finding], list[tuple[str, str, str]]]:
    """→ (new findings not in the baseline, stale baseline keys).

    Only gating severities participate: ``info`` findings neither need
    baselining nor go stale.
    """
    base_keys = {
        (b["rule"], b["file"], b["obj"]) for b in baseline
    }
    gating = [f for f in findings if f.severity in GATING]
    new = [f for f in gating if f.key not in base_keys]
    live = {f.key for f in gating}
    stale = sorted(k for k in base_keys if k not in live)
    return new, stale
