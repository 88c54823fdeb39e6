"""planlint — abstract interpretation over ``PreprocPlan`` op chains.

Counterpart of ``repro/analysis/planlint.py`` over the port's own plan IR
(``repro_torch/core/{plan,schema,vocab}.py``), with the same rules, and on
the same plan the same ``(rule, severity, obj)`` findings.

Piper's dataflow is statically known (paper Fig. 5): every column is a
straight-line op chain over a value whose dtype and range each op
transforms deterministically. This pass walks each chain with an
interval domain — ``(dtype, lo, hi)`` — and proves the properties the
runtime silently assumes:

  * index arithmetic stays inside int32: a ``Modulus`` whose range
    exceeds 2**31 produces values that do not survive the kernels'
    int32 arguments (PL101), and the saturating uint32 position
    arithmetic in ``vocab.positions`` only works while
    ``NEVER + max_rows_per_chunk`` fits uint32 (PL130), with
    ``MAX_ROWS <= NEVER`` (PL131);
  * scatter/gather indices are provably in-bounds for the
    ``VocabState`` / ``Vocabulary`` width they hit (PL102);
  * order-dependent hazards: ``Logarithm`` reachable with a
    provably-negative lower bound and no preceding ``Neg2Zero`` /
    ``Clip`` (PL110 — log1p(x) is NaN for x < -1), and a vocab
    column whose modulus range disagrees with the schema's declared
    ``vocab_range`` (PL103 — states built from the plan are not
    mergeable with schema-sized states, the stream service would
    reject the delta at ingestion);
  * dead / no-op stages: an op the interval proves is the identity
    (PL120) and ``GenVocab`` state nothing ever applies (PL121).

``validate_plan`` (plan_compiler) stays the structural gate — planlint
assumes a *valid* plan and reasons about values. Stock plans
(``criteo_default``, ``crossed_criteo``) lint clean; every rule has a
seeded negative in tests/test_torch_analysis.py, held against the
reference's findings on the same plan.
"""

from __future__ import annotations

import math

from repro_torch.analysis.findings import Finding
from repro_torch.core import plan as plan_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib

INT32_MAX = 2**31 - 1
UINT32_MAX = 2**32 - 1

# Findings anchor to the plan IR module — plans are pure data with no
# source location of their own; ``obj`` carries plan + column identity.
PLAN_FILE = "src/repro_torch/core/plan.py"

INF = math.inf


class _Absval:
    """One column's abstract value: dtype tag + inclusive interval."""

    __slots__ = ("dtype", "lo", "hi")

    def __init__(self, dtype: str, lo: float, hi: float):
        self.dtype = dtype  # "u32bits" | "i32" | "f32"
        self.lo = lo
        self.hi = hi

    def __repr__(self):
        return f"{self.dtype}[{self.lo}, {self.hi}]"


def _initial(kind: str) -> _Absval:
    if kind == "sparse":
        # raw hash bitcasts: int32 storage of uint32 bits — any value
        return _Absval("u32bits", 0, UINT32_MAX)
    # decoded dense decimal fields: full int32 (Criteo has negatives)
    return _Absval("i32", -(2**31), INT32_MAX)


def _effective_vocab_range(
    plan: plan_lib.PreprocPlan, schema: schema_lib.TableSchema
) -> int:
    """The shared Modulus range of the plan's vocab columns (validate_plan
    guarantees there is at most one), defaulting to the schema's."""
    for spec in plan.specs("sparse"):
        if any(o.name == "GenVocab" for o in spec.ops):
            for o in spec.ops:
                if o.name == "Modulus":
                    return int(o.param("range", schema.vocab_range))
    return schema.vocab_range


def lint_plan(
    plan: plan_lib.PreprocPlan,
    schema: schema_lib.TableSchema,
    *,
    plan_name: str = "plan",
    max_rows_per_chunk: int | None = None,
) -> list[Finding]:
    """Run the interval interpreter over every column chain."""
    out: list[Finding] = []

    def emit(rule, severity, col, message):
        out.append(
            Finding(
                rule=rule,
                severity=severity,
                pass_name="planlint",
                file=PLAN_FILE,
                line=0,
                obj=f"{plan_name}/{col}",
                message=message,
            )
        )

    state_width = _effective_vocab_range(plan, schema)
    applied_vocab = any(
        o.name == "ApplyVocab" for c in plan.columns for o in c.ops
    )

    for spec in plan.columns:
        col = spec.name or f"{spec.kind}:{spec.source}"
        val = _initial(spec.kind)
        for o in spec.ops:
            opdef = plan_lib.REGISTRY[o.name]
            if opdef.stage == "decode":
                continue  # folded into Decode; no value effect to model
            val = _step(emit, col, o, val, spec, schema, state_width)
        if spec.kind == "sparse" and not applied_vocab:
            if any(o.name == "GenVocab" for o in spec.ops):
                emit(
                    "PL121",
                    "warning",
                    col,
                    "GenVocab state is built but no column in the plan "
                    "ever applies it (no ApplyVocab) — dead loop-① state "
                    "unless this plan is vocab-export-only",
                )

    if max_rows_per_chunk is not None:
        out.extend(check_positions(max_rows_per_chunk, plan_name=plan_name))
    return out


def _step(emit, col, o, val, spec, schema, state_width) -> _Absval:
    """Transfer function for one compute op; may emit findings."""
    name = o.name
    if name == "HashCross":
        # mixes two raw hashes into raw bits — any uint32 value
        return _Absval("u32bits", 0, UINT32_MAX)
    if name == "Modulus":
        rng = int(o.param("range", schema.vocab_range))
        if rng - 1 > INT32_MAX:
            emit(
                "PL101",
                "error",
                col,
                f"Modulus range {rng} produces values up to {rng - 1}, "
                f"which overflows the kernels' int32 arguments "
                f"(max {INT32_MAX}) — the int32 position overflow class",
            )
        # already-reduced no-op: provably in [0, rng) on a non-bits dtype
        if val.dtype != "u32bits" and 0 <= val.lo and val.hi < rng:
            emit(
                "PL120",
                "warning",
                col,
                f"Modulus({rng}) is a no-op: input already proved in "
                f"[{val.lo}, {val.hi}]",
            )
        return _Absval("i32", 0, min(rng - 1, INT32_MAX))
    if name == "GenVocab":
        # scatter index = current value; state row width = state_width
        if val.lo < 0 or val.hi >= state_width:
            emit(
                "PL102",
                "error",
                col,
                f"GenVocab scatter index range [{val.lo}, {val.hi}] is "
                f"not provably inside the VocabState width {state_width}",
            )
        mod = next((p for p in spec.ops if p.name == "Modulus"), None)
        eff = int(mod.param("range", schema.vocab_range)) if mod else None
        if eff is not None and eff != schema.vocab_range:
            emit(
                "PL103",
                "warning",
                col,
                f"vocab column modulus range {eff} != schema.vocab_range "
                f"{schema.vocab_range}: states built from this plan are "
                "not mergeable with schema-sized states "
                "(vocab.check_compatible rejects the delta)",
            )
        return val  # GenVocab emits its input (loop-②'s view)
    if name == "ApplyVocab":
        if val.lo < 0 or val.hi >= state_width:
            emit(
                "PL102",
                "error",
                col,
                f"ApplyVocab gather index range [{val.lo}, {val.hi}] is "
                f"not provably inside the vocabulary width {state_width}",
            )
        # ordinals land in [0, size]; OOV maps to size ≤ vocab_range
        return _Absval("i32", 0, state_width)
    if name == "Neg2Zero":
        if val.lo >= 0:
            emit(
                "PL120",
                "warning",
                col,
                f"Neg2Zero is a no-op: input already proved "
                f"≥ 0 ([{val.lo}, {val.hi}])",
            )
        return _Absval("f32", max(val.lo, 0), max(val.hi, 0))
    if name == "Logarithm":
        if val.lo < 0:
            emit(
                "PL110",
                "error",
                col,
                f"Logarithm reachable with provably-negative range "
                f"[{val.lo}, {val.hi}] and no preceding Neg2Zero/Clip — "
                "log1p is NaN below -1",
            )
        lo = math.log1p(max(val.lo, 0))
        hi = math.log1p(val.hi) if val.hi < INF else INF
        return _Absval("f32", lo, hi)
    if name == "Clip":
        lo_c, hi_c = float(o.param("lo")), float(o.param("hi"))
        if lo_c <= val.lo and val.hi <= hi_c:
            emit(
                "PL120",
                "warning",
                col,
                f"Clip[{lo_c}, {hi_c}] is a no-op: input already proved "
                f"in [{val.lo}, {val.hi}]",
            )
        return _Absval(
            "f32",
            min(max(val.lo, lo_c), hi_c),
            min(max(val.hi, lo_c), hi_c),
        )
    if name == "MinMaxScale":
        return _Absval("f32", 0.0, 1.0)
    if name == "Bucketize":
        bnd = o.param("boundaries")
        return _Absval("f32", 0, len(tuple(bnd)))
    return val


def check_positions(
    max_rows_per_chunk: int, *, plan_name: str = "config"
) -> list[Finding]:
    """Prove the loop-① position arithmetic cannot wrap.

    ``vocab.positions`` computes ``rows_seen + arange(rows)`` in uint32
    and saturates at ``NEVER``; the saturation compare is only sound
    while the un-saturated sum fits uint32, i.e.
    ``NEVER + max_rows_per_chunk ≤ UINT32_MAX``. The ceiling constants
    themselves must agree (``MAX_ROWS ≤ NEVER``) for ``check_row_ceiling``
    to fire before the state can record a wrapped position.
    """
    out: list[Finding] = []
    never = int(vocab_lib.NEVER)
    if never + max_rows_per_chunk > UINT32_MAX:
        out.append(
            Finding(
                rule="PL130",
                severity="error",
                pass_name="planlint",
                file="src/repro_torch/core/vocab.py",
                line=0,
                obj=f"{plan_name}/positions",
                message=(
                    f"max_rows_per_chunk {max_rows_per_chunk} breaks the "
                    f"saturating uint32 position arithmetic: NEVER "
                    f"({never}) + chunk rows exceeds uint32 "
                    f"({UINT32_MAX}) and wraps before the saturation "
                    "compare"
                ),
            )
        )
    if int(vocab_lib.MAX_ROWS) > never:
        out.append(
            Finding(
                rule="PL131",
                severity="error",
                pass_name="planlint",
                file="src/repro_torch/core/vocab.py",
                line=0,
                obj=f"{plan_name}/row-ceiling",
                message=(
                    f"MAX_ROWS ({int(vocab_lib.MAX_ROWS)}) exceeds NEVER "
                    f"({never}): check_row_ceiling would admit rows whose "
                    "positions collide with the never-seen sentinel"
                ),
            )
        )
    return out
