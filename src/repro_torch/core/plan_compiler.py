"""Plan compiler: validate → group by signature → route → emit.

Counterpart of ``repro/core/plan_compiler.py``. Turns the declarative
:class:`~repro_torch.core.plan.PreprocPlan` IR into one executable
:class:`CompiledPlan` with the two halves the engine needs (paper
Fig. 5): a **vocab-building half** (loop ① — scatter-min first-occurrence
state over every ``GenVocab`` column, crosses included) and a
**frozen-transform half** (loop ② — the full per-chunk operator graph),
on torch tensors on the plan's device.

Compilation passes
------------------
1. **Validate** against the :class:`~repro_torch.core.schema.TableSchema`
   with the reference's rules and messages: every source column exists,
   op domains match column kinds, chains are well-ordered, params are
   sane, and all vocab columns share one modulus range (the rectangular
   :class:`~repro_torch.core.vocab.VocabState`). Failures raise
   :class:`PlanError` naming the offending column.
2. **Group by op-chain signature** — columns with the same canonical
   chain (decode-stage ops stripped) become one :class:`ColumnGroup` and
   run as one ``[rows, k]`` dispatch.
3. **Route**: every group whose chain ends ``Modulus → GenVocab →
   ApplyVocab`` (with or without a ``HashCross`` source) joins one
   vocab-apply dispatch with the canonical dense group — one launch of
   the fused loop-② kernel under the ``fused`` hint, else the unfused
   chain, whose ApplyVocab and Neg2Zero → Logarithm run the per-op
   kernels under ``use_kernels``. The vocab half is every ``GenVocab``
   column as one group: one launch of the fused loop-① kernel under the
   ``fused_vocab`` hint, else Modulus then the GenVocab kernel
   (``use_kernels``) or the plain scatter-min. Remaining groups compose
   plain PyTorch ops (route ``"xla"``, the reference's label for its
   XLA-composed stages).

Route labels. The reference names a VMEM or HBM tier where this port has
one device-memory route at every vocab range: its kernels update the
state with ``atomicMin`` and gather the table in device memory. So
``vocab_route`` and ``xform_route`` are ``"fused/device"`` or
``"unfused"``, ``decode_vocab_route`` and ``decode_xform_route``
are ``"bytes/device"`` or ``"decoded"``, and a group's ``route`` is
``"fused/device"``, ``"unfused"`` or ``"xla"``. The reference's tier
arithmetic (``tier``, ``vocab_tier``, ``vocab_slabs``) and
``static_routes`` are not ported: they feed its TPU VMEM checks.

For ``plan.criteo_default()`` every gather/subset/assembly step below is
the identity, so the emitted program is the pre-IR hard-coded chain,
bit for bit. The compiler finds that layout once, and loop ② then skips
those steps on every chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ops
from repro_torch.core import plan as plan_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib


class PlanError(ValueError):
    """A :class:`~repro_torch.core.plan.PreprocPlan` failed validation."""


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #
def _canonical_chain(spec: plan_lib.ColumnSpec) -> tuple[plan_lib.OpSpec, ...]:
    """Strip decode-stage ops (FillMissing/Hex2Int — folded into Decode)."""
    return tuple(
        o for o in spec.ops if plan_lib.REGISTRY[o.name].stage != "decode"
    )


def _col_label(spec: plan_lib.ColumnSpec) -> str:
    return spec.name or f"{spec.kind}:{spec.source}"


def validate_plan(
    plan: plan_lib.PreprocPlan, schema: schema_lib.TableSchema
) -> None:
    """Raise :class:`PlanError` unless ``plan`` is executable on ``schema``."""
    if not plan.columns:
        raise PlanError("plan has no columns")
    names = [c.name for c in plan.columns if c.name]
    if len(names) != len(set(names)):
        raise PlanError("duplicate column names in plan")
    # keyed by plan position, not label — unnamed specs sharing a source
    # would otherwise collide and mask a range mismatch
    vocab_ranges: dict[int, int] = {}
    for idx, spec in enumerate(plan.columns):
        label = _col_label(spec)
        if spec.kind not in ("dense", "sparse"):
            raise PlanError(f"{label}: unknown column kind {spec.kind!r}")
        n_src = schema.n_dense if spec.kind == "dense" else schema.n_sparse
        sources = spec.source if isinstance(spec.source, tuple) else (spec.source,)
        for s in sources:
            if not isinstance(s, int) or not 0 <= s < n_src:
                raise PlanError(
                    f"{label}: unknown column — source {s!r} not in the "
                    f"schema's {n_src} {spec.kind} columns"
                )
        seen_compute = False
        seen = {name: False for name in plan_lib.REGISTRY}
        for o in spec.ops:
            opdef = plan_lib.REGISTRY.get(o.name)
            if opdef is None:
                raise PlanError(f"{label}: unknown op {o.name!r}")
            if opdef.domain not in ("any", spec.kind):
                raise PlanError(
                    f"{label}: op {o.name} applies to {opdef.domain} columns, "
                    f"not {spec.kind}"
                )
            for k, _ in o.params:
                if k not in opdef.params:
                    raise PlanError(f"{label}: op {o.name} has no param {k!r}")
            if opdef.stage == "decode":
                if seen_compute:
                    raise PlanError(
                        f"{label}: decode-stage op {o.name} must precede "
                        "compute ops (it is folded into Decode)"
                    )
                continue
            if o.name == "HashCross":
                if seen_compute:
                    raise PlanError(
                        f"{label}: HashCross must be the first compute op"
                    )
                if not isinstance(spec.source, tuple) or len(spec.source) != 2:
                    raise PlanError(
                        f"{label}: HashCross needs a (a, b) pair source, "
                        f"got {spec.source!r}"
                    )
            seen_compute = True
            if seen[o.name] and o.name in ("Modulus", "GenVocab", "ApplyVocab"):
                raise PlanError(f"{label}: op {o.name} appears twice")
            if o.name == "GenVocab" and not seen["Modulus"]:
                raise PlanError(f"{label}: GenVocab requires a preceding Modulus")
            if o.name == "ApplyVocab" and not seen["GenVocab"]:
                raise PlanError(f"{label}: ApplyVocab requires a preceding GenVocab")
            if o.name == "Modulus":
                rng = o.param("range", schema.vocab_range)
                if not isinstance(rng, int) or rng <= 0:
                    raise PlanError(f"{label}: Modulus range must be a positive int")
            if o.name in ("Clip", "MinMaxScale"):
                lo, hi = o.param("lo"), o.param("hi")
                if lo is None or hi is None or not float(hi) > float(lo):
                    raise PlanError(f"{label}: {o.name} needs params lo < hi")
            if o.name == "Bucketize":
                bnd = o.param("boundaries")
                if not bnd or list(bnd) != sorted(set(float(x) for x in bnd)):
                    raise PlanError(
                        f"{label}: Bucketize boundaries must be a non-empty "
                        "strictly-increasing tuple"
                    )
            seen[o.name] = True
        if isinstance(spec.source, tuple) and not any(
            o.name == "HashCross" for o in spec.ops
        ):
            raise PlanError(
                f"{label}: a pair source needs a HashCross op to combine it"
            )
        if seen["GenVocab"]:
            chain = _canonical_chain(spec)
            mod = next(o for o in chain if o.name == "Modulus")
            vocab_ranges[idx] = int(mod.param("range", schema.vocab_range))
    if len(set(vocab_ranges.values())) > 1:
        raise PlanError(
            "all GenVocab columns must share one Modulus range (rectangular "
            f"VocabState), got {sorted(set(vocab_ranges.values()))}"
        )


# --------------------------------------------------------------------- #
# grouping
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ColumnGroup:
    """Columns sharing one canonical op-chain signature — one dispatch.

    ``out_slots`` are output column indices within the group's kind (plan
    order); ``sources`` are the matching input descriptors (int index or
    an ``(a, b)`` HashCross pair); ``route`` records where the compiler
    sent the group (``"fused/device"``, ``"unfused"`` or ``"xla"``).
    """

    kind: str
    signature: tuple[plan_lib.OpSpec, ...]
    out_slots: tuple[int, ...]
    sources: tuple[object, ...]
    route: str = "xla"

    def describe(self) -> str:
        chain = " → ".join(str(o) for o in self.signature) or "(identity)"
        return (
            f"[{self.kind} ×{len(self.out_slots)} → {self.route}] {chain} "
            f"(out {list(self.out_slots)})"
        )


def _group_specs(
    specs: tuple[plan_lib.ColumnSpec, ...]
) -> list[tuple[tuple[plan_lib.OpSpec, ...], list[int], list[object]]]:
    groups: dict[tuple, tuple[list[int], list[object]]] = {}
    for slot, spec in enumerate(specs):
        sig = _canonical_chain(spec)
        slots, sources = groups.setdefault(sig, ([], []))
        slots.append(slot)
        sources.append(spec.source)
    return [(sig, s, src) for sig, (s, src) in groups.items()]


def _is_vocab_apply(sig: tuple[plan_lib.OpSpec, ...]) -> bool:
    """Chain ends ``Modulus → GenVocab → ApplyVocab`` (opt. HashCross head)."""
    names = [o.name for o in sig]
    return names in (
        ["Modulus", "GenVocab", "ApplyVocab"],
        ["HashCross", "Modulus", "GenVocab", "ApplyVocab"],
    )


def _is_dense_canonical(sig: tuple[plan_lib.OpSpec, ...]) -> bool:
    return [o.name for o in sig] == ["Neg2Zero", "Logarithm"]


# The port's route labels where the reference names a memory tier: one
# device-memory route at every vocab range (see the module docstring).
FUSED_ROUTE = "fused/device"
BYTES_ROUTE = "bytes/device"


# --------------------------------------------------------------------- #
# the compiled program
# --------------------------------------------------------------------- #
class CompiledPlan:
    """One program: loop-① ``vocab_step`` + loop-② ``transform``.

    Built by :func:`compile_plan`; the engine holds one instance and calls
    its halves per chunk. The instance holds only static routing data and
    the index tensors it gathers with, on ``device``.
    """

    def __init__(
        self,
        plan: plan_lib.PreprocPlan,
        schema: schema_lib.TableSchema,
        *,
        device: torch.device | str,
        fused: bool,
        use_kernels: bool,
        fused_vocab: bool = False,
        fused_decode: bool = False,
        track_counts: bool = False,
    ):
        validate_plan(plan, schema)
        self.plan = plan
        self.schema = schema
        self.device = torch.device(device)
        self.fused = fused
        self.fused_vocab = fused_vocab
        self.fused_decode = fused_decode
        self.use_kernels = use_kernels
        self.track_counts = track_counts
        self.n_dense_out = plan.n_dense_out
        self.n_sparse_out = plan.n_sparse_out
        self._index_cache: dict[tuple, torch.Tensor] = {}

        sparse_specs = plan.specs("sparse")
        dense_specs = plan.specs("dense")

        # vocab rows: every GenVocab column, in plan (sparse-slot) order.
        self._vocab_sources: tuple[object, ...] = tuple(
            spec.source
            for spec in sparse_specs
            if any(o.name == "GenVocab" for o in spec.ops)
        )
        self.n_vocab_columns = len(self._vocab_sources)
        self.vocab_range = schema.vocab_range
        vocab_row_of: dict[int, int] = {}
        row = 0
        for slot, spec in enumerate(sparse_specs):
            chain = _canonical_chain(spec)
            if any(o.name == "GenVocab" for o in chain):
                mod = next(o for o in chain if o.name == "Modulus")
                self.vocab_range = int(mod.param("range", schema.vocab_range))
                vocab_row_of[slot] = row
                row += 1

        # group by signature, then route: vocab-apply groups merge into the
        # single vocab-apply dispatch; everything else composes plain ops.
        sparse_groups = _group_specs(sparse_specs)
        dense_groups = _group_specs(dense_specs)
        self._n_apply_columns = sum(
            len(slots) for sig, slots, _ in sparse_groups if _is_vocab_apply(sig)
        )
        # The fused kernel carries sparse AND dense columns, so the fused
        # dispatch requires both halves, as in the reference; plans without
        # one run the (kernel-dispatched) unfused chain instead.
        has_canonical_dense = any(
            _is_dense_canonical(sig) for sig, _, _ in dense_groups
        )
        self._fused_dispatch = (
            fused and self._n_apply_columns > 0 and has_canonical_dense
        )
        # Loop ①'s single canonical group is "every GenVocab column"
        # (crosses materialize at gather time and join the same rows), so
        # the whole vocab half is ONE fused dispatch whenever the hint is on
        # and there is state to build.
        self._fused_vocab_dispatch = fused_vocab and self.n_vocab_columns > 0
        apply_slots: list[int] = []
        apply_sources: list[object] = []
        apply_rows: list[int] = []
        self._sparse_xla: list[tuple[tuple, tuple, tuple]] = []
        self.groups: list[ColumnGroup] = []
        for sig, slots, sources in sparse_groups:
            if _is_vocab_apply(sig):
                apply_slots.extend(slots)
                apply_sources.extend(sources)
                apply_rows.extend(vocab_row_of[s] for s in slots)
                route = FUSED_ROUTE if self._fused_dispatch else "unfused"
            else:
                self._sparse_xla.append((sig, tuple(slots), tuple(sources)))
                route = "xla"
            self.groups.append(
                ColumnGroup("sparse", sig, tuple(slots), tuple(sources), route)
            )
        self._apply_slots = tuple(apply_slots)
        self._apply_sources = tuple(apply_sources)
        self._apply_vocab_rows = tuple(apply_rows)

        fused_dense_slots: list[int] = []
        fused_dense_sources: list[int] = []
        self._dense_xla: list[tuple[tuple, tuple, tuple]] = []
        for sig, slots, sources in dense_groups:
            # the canonical dense chain rides the vocab-apply dispatch only
            # when a vocab-apply group exists to share it with; standalone
            # it still runs the (kernel-dispatched) dense pass.
            if _is_dense_canonical(sig) and self._apply_slots:
                fused_dense_slots.extend(slots)
                fused_dense_sources.extend(sources)
                route = FUSED_ROUTE if self._fused_dispatch else "unfused"
            else:
                self._dense_xla.append((sig, tuple(slots), tuple(sources)))
                route = "xla"
            self.groups.append(
                ColumnGroup("dense", sig, tuple(slots), tuple(sources), route)
            )
        self._fused_dense_slots = tuple(fused_dense_slots)
        self._fused_dense_sources = tuple(fused_dense_sources)

        # Bytes-in routing (kernels/fused_decode_*): the bytes-in kernels
        # scatter every schema column straight into the state / output
        # table, so they only apply when the plan is the *identity over
        # the wire layout* — no crossed/subset/permuted sources, every
        # sparse column a vocab column, the canonical dense chain on
        # every dense column, nothing routed to plain-op stages. Anything
        # else keeps the decoded-input paths.
        identity_sparse = tuple(range(schema.n_sparse))
        identity_dense = tuple(range(schema.n_dense))
        self.decode_vocab_dispatch = (
            fused_decode
            and schema.n_sparse > 0
            and self._vocab_sources == identity_sparse
            # the bytes-in kernel carries no count plane
            and not track_counts
        )
        # criteo_default's shape: loop ② runs the vocab-apply dispatch on
        # the chunk as it is, with no gather, subset or assembly.
        self._wire_identity = (
            schema.n_sparse > 0
            and schema.n_dense > 0
            and self.n_sparse_out == schema.n_sparse
            and self.n_dense_out == schema.n_dense
            and self._apply_slots == tuple(range(self.n_sparse_out))
            and self._apply_sources == identity_sparse
            and self._apply_vocab_rows == tuple(range(schema.n_sparse))
            and self._fused_dense_slots == tuple(range(self.n_dense_out))
            and self._fused_dense_sources == identity_dense
            and not self._sparse_xla
            and not self._dense_xla
        )
        self.decode_xform_dispatch = fused_decode and self._wire_identity

    # -- metadata ------------------------------------------------------ #
    @property
    def vocab_route(self) -> str:
        """Where the compiler sent the vocab-building half:
        ``"fused/device"`` (the fused loop-① kernel) or ``"unfused"``
        (Modulus, then the GenVocab kernel under ``use_kernels`` or the
        plain scatter-min)."""
        return FUSED_ROUTE if self._fused_vocab_dispatch else "unfused"

    @property
    def xform_route(self) -> str:
        """Where the compiler sent the canonical loop-② half:
        ``"fused/device"`` or ``"unfused"``."""
        return FUSED_ROUTE if self._fused_dispatch else "unfused"

    @property
    def decode_vocab_route(self) -> str:
        """Where a utf8 engine's loop ① enters: ``"bytes/device"`` (the
        bytes-in kernel) or ``"decoded"`` (decode runs as its own
        dispatch)."""
        return BYTES_ROUTE if self.decode_vocab_dispatch else "decoded"

    @property
    def decode_xform_route(self) -> str:
        """Where a utf8 engine's loop ② enters. The reference's tier here
        depends on ``max_rows``; the port's bytes-in kernel writes the
        output table to device memory at any ``max_rows``, so this takes
        no argument."""
        return BYTES_ROUTE if self.decode_xform_dispatch else "decoded"

    def describe(self) -> str:
        head = (
            f"CompiledPlan: {self.n_dense_out} dense + {self.n_sparse_out} "
            f"sparse out, {self.n_vocab_columns} vocab columns @ range "
            f"{self.vocab_range}, fused={self.fused} "
            f"(dispatch={self.xform_route})"
        )
        vocab_half = (
            f"[vocab ×{self.n_vocab_columns} → {self.vocab_route}] "
            "Modulus → GenVocab (loop ① scatter-min)"
        )
        decode_half = (
            f"[decode → loop① {self.decode_vocab_route}, loop② "
            f"{'bytes' if self.decode_xform_dispatch else 'decoded'}] "
            "utf8 bytes-in fusion (kernels/fused_decode_*)"
        )
        return "\n".join(
            [head, vocab_half, decode_half] + [g.describe() for g in self.groups]
        )

    # -- gather / subset / assembly helpers ---------------------------- #
    def _index(self, positions: tuple[int, ...], device: torch.device) -> torch.Tensor:
        """``positions`` as an int64 tensor on ``device``, made once."""
        key = (positions, device)
        idx = self._index_cache.get(key)
        if idx is None:
            idx = torch.tensor(positions, dtype=torch.int64, device=device)
            self._index_cache[key] = idx
        return idx

    def _gather_sparse(self, sparse: torch.Tensor, sources: tuple) -> torch.Tensor:
        """[rows, n_sparse] input → [rows, len(sources)] in source order;
        pair sources materialize their HashCross column. Identity sources
        return the input tensor unchanged (no-op for criteo_default)."""
        if sources == tuple(range(sparse.shape[1])):
            return sparse
        if not sources:
            return sparse[:, :0]
        parts = []
        for s in sources:
            if isinstance(s, tuple):
                parts.append(ops.hash_cross(sparse[:, s[0]], sparse[:, s[1]])[:, None])
            else:
                parts.append(sparse[:, s : s + 1])
        return torch.cat(parts, dim=1)

    def _gather_dense(self, dense: torch.Tensor, sources: tuple) -> torch.Tensor:
        if sources == tuple(range(dense.shape[1])):
            return dense
        if not sources:
            return dense[:, :0]
        return dense.index_select(1, self._index(sources, dense.device))

    def _vocab_subset(
        self, vocabulary: vocab_lib.Vocabulary, rows: tuple[int, ...]
    ) -> vocab_lib.Vocabulary:
        if rows == tuple(range(int(vocabulary.table.shape[0]))):
            return vocabulary
        return vocab_lib.Vocabulary(
            table=vocabulary.table.index_select(0, self._index(rows, vocabulary.table.device)),
            sizes=vocabulary.sizes.index_select(0, self._index(rows, vocabulary.sizes.device)),
        )

    def _assemble(self, pieces, n_out: int, rows: int, dtype, device) -> torch.Tensor:
        """Scatter group outputs back to plan column order. A single piece
        already covering every slot in order passes through untouched."""
        if len(pieces) == 1 and pieces[0][0] == tuple(range(n_out)):
            return pieces[0][1].to(dtype)
        out = torch.empty((rows, n_out), dtype=dtype, device=device)
        for slots, mat in pieces:
            out.index_copy_(1, self._index(slots, device), mat.to(dtype))
        return out

    # -- op evaluation for plain-op groups ----------------------------- #
    def _eval_sparse(self, raw: torch.Tensor, sig) -> torch.Tensor:
        x = raw
        for o in sig:
            if o.name == "HashCross":
                pass  # applied at gather time (pair sources)
            elif o.name == "Modulus":
                # default = schema.vocab_range, matching validate_plan —
                # NOT the vocab columns' (possibly overridden) range.
                x = ops.positive_modulus(
                    x, int(o.param("range", self.schema.vocab_range))
                )
            elif o.name == "GenVocab":
                pass  # loop-①-only (the column emits its modded values)
            else:
                # ApplyVocab chains route to the vocab-apply dispatch;
                # anything else is a registry op this compiler does not yet
                # lower — fail loudly instead of serving un-transformed values.
                raise PlanError(f"unhandled sparse op {o.name} in compiler")
        return x

    def _eval_dense(self, raw: torch.Tensor, sig) -> torch.Tensor:
        names = [o.name for o in sig]
        if names == ["Neg2Zero", "Logarithm"]:
            # the canonical pair keeps its kernel-dispatched dense pass
            return ops.dense_transform(raw, use_kernel=self.use_kernels)
        x = raw.to(torch.float32)
        for o in sig:
            if o.name == "Neg2Zero":
                x = ops.neg2zero(x)
            elif o.name == "Logarithm":
                x = ops.logarithm(x)
            elif o.name == "Clip":
                x = ops.clip(x, float(o.param("lo")), float(o.param("hi")))
            elif o.name == "MinMaxScale":
                x = ops.minmax_scale(x, float(o.param("lo")), float(o.param("hi")))
            elif o.name == "Bucketize":
                x = ops.bucketize(x, tuple(o.param("boundaries")))
            else:
                raise PlanError(f"unhandled dense op {o.name} in compiler")
        return x

    # -- loop ① — vocab-building half ---------------------------------- #
    def init_state(self) -> vocab_lib.VocabState:
        return vocab_lib.VocabState.init(
            self.n_vocab_columns,
            self.vocab_range,
            track_counts=self.track_counts,
            device=self.device,
        )

    def vocab_step(
        self, state: vocab_lib.VocabState, batch: schema_lib.TabularBatch
    ) -> vocab_lib.VocabState:
        """Absorb one decoded chunk into the first-occurrence state —
        every GenVocab column (crosses materialized first), one scatter.

        With the ``fused_vocab`` hint the whole chain (uint32 Modulus →
        scatter-min) is ONE launch of the fused loop-① kernel; with
        ``use_kernels`` the scatter-min is one launch of the GenVocab
        kernel. Both update ``state`` in place on the card: thread the
        returned state through. The state is bit-identical on every
        route."""
        raw = self._gather_sparse(batch.sparse, self._vocab_sources)
        if self._fused_vocab_dispatch:
            return ops.fused_vocab_update(state, raw, batch.valid)
        modded = ops.positive_modulus(raw, self.vocab_range)
        if self.use_kernels:
            from repro_torch.kernels.vocab import ops as vocab_ops

            return vocab_ops.genvocab_update(state, modded, batch.valid)
        return vocab_lib.update(state, modded, batch.valid)

    def vocab_step_bytes(
        self,
        state: vocab_lib.VocabState,
        byte_buf: torch.Tensor,
        *,
        max_rows: int,
    ) -> vocab_lib.VocabState:
        """Loop ① straight from a raw UTF-8 chunk — Decode → Modulus →
        scatter-min as ONE launch (kernels/fused_decode_vocab). Only valid
        when :attr:`decode_vocab_dispatch` is set (the plan is the identity
        over the wire layout); bit-identical to ``vocab_step`` on the
        decoded chunk."""
        return ops.fused_decode_vocab_update(
            state,
            byte_buf,
            n_fields=self.schema.n_fields,
            n_dense=self.schema.n_dense,
            n_sparse=self.schema.n_sparse,
            max_rows=max_rows,
        )

    def transform_bytes(
        self,
        vocabulary: vocab_lib.Vocabulary,
        byte_buf: torch.Tensor,
        *,
        max_rows: int,
    ) -> schema_lib.ProcessedBatch:
        """Loop ② straight from a raw UTF-8 chunk — Decode → Modulus →
        ApplyVocab ∥ Neg2Zero → Logarithm as ONE launch
        (kernels/fused_decode_xform). Only valid when
        :attr:`decode_xform_dispatch` is set; ids/labels bit-identical and
        dense within rtol 1e-6 of ``transform`` on the decoded chunk,
        padding rows included."""
        vsub = self._vocab_subset(vocabulary, self._apply_vocab_rows)
        label, dense, ids, valid = ops.fused_decode_transform(
            vsub,
            byte_buf,
            n_fields=self.schema.n_fields,
            n_dense=self.schema.n_dense,
            n_sparse=self.schema.n_sparse,
            max_rows=max_rows,
        )
        return schema_lib.ProcessedBatch(label=label, dense=dense, sparse=ids, valid=valid)

    # -- loop ② — frozen-transform half -------------------------------- #
    def _vocab_apply(
        self, vocabulary: vocab_lib.Vocabulary, sparse: torch.Tensor, dense: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The vocab-apply group's ids and its canonical dense columns."""
        if self._fused_dispatch:
            # Piper's dataflow: the whole chain in one launch — no
            # modded/ids/dense intermediates round-tripping memory.
            return ops.fused_transform(vocabulary, sparse, dense)
        modded = ops.positive_modulus(sparse, self.vocab_range)
        return (
            ops.apply_vocab(vocabulary, modded, use_kernel=self.use_kernels),
            ops.dense_transform(dense, use_kernel=self.use_kernels),
        )

    def transform(
        self, vocabulary: vocab_lib.Vocabulary, batch: schema_lib.TabularBatch
    ) -> schema_lib.ProcessedBatch:
        """The whole per-chunk operator graph with a frozen vocabulary."""
        if self._wire_identity:
            ids, dfx = self._vocab_apply(vocabulary, batch.sparse, batch.dense)
            return schema_lib.ProcessedBatch(
                label=batch.label, dense=dfx, sparse=ids, valid=batch.valid
            )
        rows = int(batch.sparse.shape[0])
        device = batch.sparse.device
        sparse_pieces, dense_pieces = [], []

        if self._apply_slots:
            ids, dfx = self._vocab_apply(
                self._vocab_subset(vocabulary, self._apply_vocab_rows),
                self._gather_sparse(batch.sparse, self._apply_sources),
                self._gather_dense(batch.dense, self._fused_dense_sources),
            )
            sparse_pieces.append((self._apply_slots, ids))
            if self._fused_dense_slots:
                dense_pieces.append((self._fused_dense_slots, dfx))

        for sig, slots, sources in self._sparse_xla:
            raw = self._gather_sparse(batch.sparse, sources)
            sparse_pieces.append((slots, self._eval_sparse(raw, sig)))
        for sig, slots, sources in self._dense_xla:
            raw = self._gather_dense(batch.dense, sources)
            dense_pieces.append((slots, self._eval_dense(raw, sig)))

        return schema_lib.ProcessedBatch(
            label=batch.label,
            dense=self._assemble(dense_pieces, self.n_dense_out, rows, torch.float32, device),
            sparse=self._assemble(sparse_pieces, self.n_sparse_out, rows, torch.int32, device),
            valid=batch.valid,
        )


def compile_plan(
    plan: plan_lib.PreprocPlan,
    schema: schema_lib.TableSchema,
    *,
    device: torch.device | str = "cuda",
    fused: bool = False,
    use_kernels: bool = False,
    fused_vocab: bool = False,
    fused_decode: bool = False,
    track_counts: bool = False,
) -> CompiledPlan:
    """Validate + group + route ``plan`` into a :class:`CompiledPlan` that
    runs on ``device``.

    The hints are the resolved ``PipelineConfig`` fields, which own the
    rule for their ``None``: ``fused`` (``fused_enabled``) for the loop-②
    half, ``fused_vocab`` (``fused_vocab_enabled``) for the loop-① half,
    and ``fused_decode`` (``fused_decode_enabled``) for the bytes-in
    dispatches (utf8 feeds only — the engine consults the routing, the
    compiler records admissibility). ``use_kernels`` routes the unfused
    per-op stages (GenVocab, ApplyVocab, Neg2Zero → Logarithm) through
    their kernels. ``track_counts`` builds the state with the
    occurrence-count plane (``PipelineConfig.track_vocab_counts``).
    On the CPU every kernel wrapper takes its plain version.
    """
    return CompiledPlan(
        plan,
        schema,
        device=torch.device(device),
        fused=bool(fused),
        use_kernels=bool(use_kernels),
        fused_vocab=bool(fused_vocab),
        fused_decode=bool(fused_decode),
        track_counts=bool(track_counts),
    )
