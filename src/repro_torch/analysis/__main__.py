"""The command line: run the four passes, report, diff the baseline, gate.

    PYTHONPATH=src python -m repro_torch.analysis [--strict] [--json OUT]
        [--baseline analysis/torch_baseline.json] [--passes a,b,c]
        [--write-baseline PATH] [--device cpu|cuda]

Counterpart of ``repro/analysis/__main__.py``, with its output and exit
contract. Exit status: 0 unless ``--strict`` and there are gating
findings (severity error/warning) outside the baseline, or stale
baseline entries the code no longer produces. The expected steady state
is zero new findings and an empty, reviewed baseline.

The passes run on the card when one is present (``--device`` defaults to
``cuda`` then, else to ``cpu``). On the CPU the checks that need the card
(the kernels' launch configs and ptxas logs, the sync-debug mode) are
skipped, and the report names them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.analysis import findings as findings_lib

PASSES = ("planlint", "kernelcheck", "launches", "locklint")
DEFAULT_BASELINE = "analysis/torch_baseline.json"
# what the launch audit leaves to the card when it runs on the CPU
LAUNCHES_CARD_ONLY = (
    "launches: JX301 under torch.cuda.set_sync_debug_mode(\"error\") (on the CPU the audit "
    "sees no CUDA tensor)",
)


def repo_root() -> str:
    """src/repro_torch/analysis/__main__.py → the repo checkout root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_planlint(root: str) -> list:
    from repro_torch.analysis import planlint
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import schema as schema_lib

    chunk_rows = pipeline_lib.PipelineConfig.max_rows_per_chunk
    out = []
    for name, plan, schema in (
        ("criteo-5k", plan_lib.criteo_default(schema_lib.CRITEO), schema_lib.CRITEO),
        (
            "criteo-1m",
            plan_lib.criteo_default(schema_lib.CRITEO_1M),
            schema_lib.CRITEO_1M,
        ),
        ("crossed", plan_lib.crossed_criteo(schema_lib.CRITEO), schema_lib.CRITEO),
    ):
        out.extend(
            planlint.lint_plan(
                plan, schema, plan_name=name, max_rows_per_chunk=chunk_rows
            )
        )
    return out


def run_kernelcheck(root: str, device) -> tuple[list, dict]:
    from repro_torch.analysis import kernelcheck

    return kernelcheck.run(root, device=device)


def run_launches(root: str, device) -> tuple[list, dict]:
    from repro_torch.analysis import launch_audit

    return launch_audit.run(root, device=device)


def run_locklint(root: str) -> list:
    from repro_torch.analysis import locklint

    return locklint.run(root)


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_passes(
    root: str, passes: tuple[str, ...] = PASSES, device=None
) -> tuple[list, dict]:
    """The passes on ``device`` (:func:`default_device` when None) →
    (findings, stats). ``stats`` holds the hot-path dispatches, the
    kernelcheck report, and under ``skipped`` what needs the card."""
    device = torch.device(device or default_device())
    all_findings: list = []
    stats: dict = {"device": str(device), "skipped": []}
    if "planlint" in passes:
        all_findings.extend(run_planlint(root))
    if "kernelcheck" in passes:
        kc_findings, kc_report = run_kernelcheck(root, device)
        all_findings.extend(kc_findings)
        stats["skipped"] += kc_report.pop("skipped", [])
        stats["kernelcheck"] = kc_report
    if "launches" in passes:
        la_findings, la_stats = run_launches(root, device)
        all_findings.extend(la_findings)
        stats["dispatches"] = la_stats
        if device.type != "cuda":
            stats["skipped"] += list(LAUNCHES_CARD_ONLY)
    if "locklint" in passes:
        all_findings.extend(run_locklint(root))
    return all_findings, stats


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="exit 1 on gating findings outside the baseline (the CI gate)",
    )
    ap.add_argument("--json", default="", help="write the findings report here")
    ap.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help="reviewed residual findings (repo-relative; default "
        f"{DEFAULT_BASELINE}; 'none' disables)",
    )
    ap.add_argument(
        "--write-baseline",
        default="",
        help="write the current gating findings as a fresh baseline and exit",
    )
    ap.add_argument(
        "--passes",
        default=",".join(PASSES),
        help=f"comma-separated subset of {', '.join(PASSES)}",
    )
    ap.add_argument("--root", default="", help="repo root (default: inferred)")
    ap.add_argument(
        "--device",
        default="",
        help="cpu or cuda (default: cuda when a card is present, else cpu)",
    )
    args = ap.parse_args(argv)

    root = args.root or repo_root()
    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(unknown)}")

    findings, stats = run_passes(root, passes, args.device or None)
    findings.sort(key=lambda f: (f.pass_name, f.file, f.line, f.rule, f.obj))

    if args.write_baseline:
        gating = [
            f for f in findings if f.severity in findings_lib.GATING
        ]
        with open(args.write_baseline, "w") as f:
            json.dump(findings_lib.dump_findings(gating), f, indent=2)
            f.write("\n")
        print(f"wrote {len(gating)} gating finding(s) to {args.write_baseline}")
        return 0

    baseline: list[dict] = []
    baseline_path = ""
    if args.baseline != "none":
        baseline_path = (
            args.baseline
            if os.path.isabs(args.baseline)
            else os.path.join(root, args.baseline)
        )
        if os.path.exists(baseline_path):
            baseline = findings_lib.load_baseline(baseline_path)
    new, stale = findings_lib.diff_baseline(findings, baseline)

    new_keys = {f.key for f in new}
    by_pass: dict[str, list] = {}
    for f in findings:
        by_pass.setdefault(f.pass_name, []).append(f)
    for pass_name in PASSES:
        if pass_name not in passes:
            continue
        fs = by_pass.get(pass_name, [])
        print(f"== {pass_name}: {len(fs)} finding(s)")
        for f in fs:
            suffix = ""
            if f.severity in findings_lib.GATING and f.key not in new_keys:
                suffix = "  (baselined)"
            print(f"  {f.render()}{suffix}")
    if "dispatches" in stats:
        print("== hot-path dispatches per chunk")
        for k, v in sorted(stats["dispatches"].items()):
            print(f"  {k}: {v}")
    n_gating = sum(1 for f in findings if f.severity in findings_lib.GATING)
    print(
        f"== total: {len(findings)} finding(s), {n_gating} gating, "
        f"{len(new)} new vs baseline, {len(stale)} stale baseline entr"
        f"{'y' if len(stale) == 1 else 'ies'}"
    )
    for key in stale:
        print(f"  stale baseline entry (fixed? remove it): {key}")
    print(f"== device: {stats['device']}")
    for what in stats["skipped"]:
        print(f"  skipped (needs the card): {what}")

    if args.json:
        report = findings_lib.dump_findings(
            findings,
            extra={
                "stats": stats,
                "new": [f.to_dict() for f in new],
                "stale": [list(k) for k in stale],
            },
        )
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote {args.json}")

    if args.strict and (new or stale):
        print(
            "STRICT: failing on "
            f"{len(new)} new finding(s) / {len(stale)} stale entr"
            f"{'y' if len(stale) == 1 else 'ies'} "
            f"(baseline: {baseline_path or 'disabled'})",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
