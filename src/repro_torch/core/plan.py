"""Declarative per-column preprocessing-plan IR (paper Table 1 / Fig. 5).

Piper's pipeline is an operator *graph*, not a hard-coded chain: §5
positions the architecture to "cater to tabular datasets" beyond Criteo.
This module is the graph's declarative form — a :class:`PreprocPlan` of
:class:`ColumnSpec`\\ s, each naming an op chain from the registry below —
mirroring how tf.data models preprocessing as composable ops so the same
program runs offline and in the disaggregated service unchanged.

Counterpart of ``repro/core/plan.py``: the same names, the same
dataclasses and the same ``describe()`` text, on the port's own
:class:`~repro_torch.core.schema.TableSchema`.

The IR is **pure data**: frozen dataclasses of tuples, hashable, with no
torch imports — so a plan can sit inside the (frozen, hashable)
``PipelineConfig`` and ride through ``dataclasses.replace``. All
execution lives in :mod:`repro_torch.core.plan_compiler`, which
validates a plan against a :class:`~repro_torch.core.schema.TableSchema`,
groups columns by op-chain signature, and routes each group to a fused
kernel, the per-op kernels or plain PyTorch ops.

Op registry
-----------
==============  ======  =====================================================
op              domain  semantics
==============  ======  =====================================================
``FillMissing``  any    empty field → 0. Folded into Decode (paper: the FPGA
                        fills during parsing); accepted at the chain head for
                        Table-1 fidelity and stripped by the compiler.
``Hex2Int``     sparse  hex string → uint32. Also folded into Decode; chain-
                        head only, stripped by the compiler.
``HashCross``   sparse  two-column cross: mixes the raw hashes of two source
                        sparse columns into one synthetic sparse column
                        (``ops.hash_cross``). Must be the first compute op
                        and requires a pair source.
``Modulus``     sparse  uint32 ``% range`` (param ``range``, default =
                        ``schema.vocab_range``).
``GenVocab``    sparse  loop ①: accumulate first-occurrence vocabulary state
                        for this column. Requires a preceding ``Modulus``.
``ApplyVocab``  sparse  loop ②: map modded values through the finalized
                        table. Requires a preceding ``GenVocab``.
``Neg2Zero``    dense   ``max(x, 0)``.
``Logarithm``   dense   ``log1p(x)`` (f32).
``Clip``        dense   clamp to ``[lo, hi]`` (params ``lo``, ``hi``).
``MinMaxScale`` dense   clip to ``[lo, hi]`` then rescale to ``[0, 1]``.
``Bucketize``   dense   value → f32 bucket index via ``searchsorted``
                        (param ``boundaries``: strictly-increasing tuple;
                        ``x == boundary`` lands in the upper bucket).
==============  ======  =====================================================

``plan.criteo_default(schema)`` is the exact chain the engines ran before
the IR existed — every sparse column ``FillMissing → Hex2Int → Modulus →
GenVocab → ApplyVocab``, every dense column ``FillMissing → Neg2Zero →
Logarithm`` — and compiles to the bit-identical program
(tests/test_torch_plan.py pins it against the golden fixture).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import schema as schema_lib

# ---------------------------------------------------------------------- #
# op registry
# ---------------------------------------------------------------------- #

# domain: which column kind the op may appear on; stage:
#   "decode"  — folded into Decode, chain-head only, stripped
#   "source"  — produces the column's raw value (HashCross)
#   "compute" — a loop-①/② transform
@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str
    domain: str                      # "dense" | "sparse" | "any"
    stage: str = "compute"
    params: tuple[str, ...] = ()     # accepted param names


REGISTRY: dict[str, OpDef] = {
    d.name: d
    for d in (
        OpDef("FillMissing", "any", stage="decode"),
        OpDef("Hex2Int", "sparse", stage="decode"),
        OpDef("HashCross", "sparse", stage="source"),
        OpDef("Modulus", "sparse", params=("range",)),
        OpDef("GenVocab", "sparse"),
        OpDef("ApplyVocab", "sparse"),
        OpDef("Neg2Zero", "dense"),
        OpDef("Logarithm", "dense"),
        OpDef("Clip", "dense", params=("lo", "hi")),
        OpDef("MinMaxScale", "dense", params=("lo", "hi")),
        OpDef("Bucketize", "dense", params=("boundaries",)),
    )
}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One op application: registry name + hashable ``(key, value)`` params."""

    name: str
    params: tuple[tuple[str, object], ...] = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def __str__(self) -> str:
        if not self.params:
            return self.name
        kv = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}({kv})"


def op(name: str, **params) -> OpSpec:
    """Build an :class:`OpSpec`; tuple-ifies list params so specs stay
    hashable (``op("Bucketize", boundaries=[0, 10])`` works)."""
    norm = tuple(
        sorted(
            (k, tuple(v) if isinstance(v, list) else v) for k, v in params.items()
        )
    )
    return OpSpec(name=name, params=norm)


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One output column: a source in the input table + its op chain.

    ``kind``    "dense" or "sparse" — which output matrix the column lands in.
    ``source``  input column index within its kind, or an ``(a, b)`` pair of
                sparse input indices for a synthetic ``HashCross`` column.
    ``ops``     the chain, in application order.
    ``name``    stable output label (defaults applied by ``PreprocPlan``).
    """

    kind: str
    source: int | tuple[int, int]
    ops: tuple[OpSpec, ...]
    name: str = ""


@dataclasses.dataclass(frozen=True)
class PreprocPlan:
    """An ordered tuple of column specs — the whole preprocessing program.

    Column order *is* output order: the k-th dense spec becomes output
    dense column k, likewise for sparse. The plan is pure data; compile
    it with :func:`repro_torch.core.plan_compiler.compile_plan`.
    """

    columns: tuple[ColumnSpec, ...]

    def specs(self, kind: str) -> tuple[ColumnSpec, ...]:
        return tuple(c for c in self.columns if c.kind == kind)

    @property
    def n_dense_out(self) -> int:
        return len(self.specs("dense"))

    @property
    def n_sparse_out(self) -> int:
        return len(self.specs("sparse"))

    def describe(self) -> str:
        lines = []
        for c in self.columns:
            chain = " → ".join(str(o) for o in c.ops) or "(identity)"
            lines.append(f"{c.name or c.source}: [{c.kind}:{c.source}] {chain}")
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# canonical chains + stock plans
# ---------------------------------------------------------------------- #

# The pre-IR hard-coded chains (paper Fig. 5), reused by the compiler to
# recognize groups it can route through the fused kernel.
SPARSE_CANONICAL = (op("FillMissing"), op("Hex2Int"), op("Modulus"),
                    op("GenVocab"), op("ApplyVocab"))
DENSE_CANONICAL = (op("FillMissing"), op("Neg2Zero"), op("Logarithm"))


def criteo_default(schema: schema_lib.TableSchema = schema_lib.CRITEO) -> PreprocPlan:
    """The exact chain the engines hard-coded before the plan IR: every
    dense column ``Neg2Zero → Logarithm``, every sparse column ``Modulus →
    GenVocab → ApplyVocab`` (decode-stage ops included for Table-1
    fidelity). Compiles bit-identically to the pre-refactor pipeline."""
    cols = [
        ColumnSpec(kind="dense", source=i, ops=DENSE_CANONICAL, name=f"d{i}")
        for i in range(schema.n_dense)
    ] + [
        ColumnSpec(kind="sparse", source=j, ops=SPARSE_CANONICAL, name=f"s{j}")
        for j in range(schema.n_sparse)
    ]
    return PreprocPlan(columns=tuple(cols))


def crossed_criteo(
    schema: schema_lib.TableSchema = schema_lib.CRITEO,
    crosses: tuple[tuple[int, int], ...] = ((0, 1),),
    bucket_cols: tuple[int, ...] = (0,),
    boundaries: tuple[float, ...] = (0.0, 1.0, 10.0, 100.0, 1000.0),
) -> PreprocPlan:
    """A non-Criteo demo plan: the default chains plus ``crosses`` synthetic
    ``HashCross → Modulus → GenVocab → ApplyVocab`` sparse columns, with the
    dense columns in ``bucket_cols`` bucketized instead of log-transformed.
    Exercises every routing path: fused canonical groups, a per-group dense
    chain, and cross-fed vocab columns."""
    cols: list[ColumnSpec] = []
    for i in range(schema.n_dense):
        if i in bucket_cols:
            cols.append(
                ColumnSpec(
                    kind="dense",
                    source=i,
                    ops=(op("FillMissing"), op("Bucketize", boundaries=boundaries)),
                    name=f"d{i}_bkt",
                )
            )
        else:
            cols.append(
                ColumnSpec(kind="dense", source=i, ops=DENSE_CANONICAL, name=f"d{i}")
            )
    for j in range(schema.n_sparse):
        cols.append(
            ColumnSpec(kind="sparse", source=j, ops=SPARSE_CANONICAL, name=f"s{j}")
        )
    for a, b in crosses:
        cols.append(
            ColumnSpec(
                kind="sparse",
                source=(a, b),
                ops=(op("HashCross"), op("Modulus"), op("GenVocab"),
                     op("ApplyVocab")),
                name=f"s{a}xs{b}",
            )
        )
    return PreprocPlan(columns=tuple(cols))
