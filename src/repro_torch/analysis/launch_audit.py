"""launch audit — dispatch counting and hot-path hygiene, by running the
compiled plan's entry points under a ``TorchDispatchMode``.

Counterpart of ``repro/analysis/jaxpr_audit.py``. The reference traces
jaxprs; PyTorch runs eagerly, so this pass runs the hot-path entry points
(``CompiledPlan.vocab_step`` / ``transform`` and their bytes-in variants)
once on small inputs and records what they dispatch:

  * **dispatch counts** (:func:`count_dispatches`): the aten ops a call
    dispatches, views and allocations left out (they launch nothing), and
    a hand-kernel entry — an ``ops.py`` wrapper marked with
    ``_build.entry``, which launches its kernel on the card and runs its
    plain version on the CPU — as ONE dispatch that is not descended into,
    as a ``pallas_call`` counts as one in the reference. JX303 (error)
    fires when a fused route fails to dispatch strictly fewer than its
    unfused twin — the paper's no-materialization property;
  * **host synchronisation** (JX301, error): a scalar read
    (``_local_scalar_dense``, what ``item``, ``int`` and ``bool`` of a
    tensor dispatch), ``equal``, ``is_nonzero``, ``nonzero`` or
    ``masked_select`` (whose output size needs the device), or a device →
    host copy, of a CUDA tensor, outside a kernel entry. On the card the
    entry points also run under ``torch.cuda.set_sync_debug_mode("error")``,
    which decides inside the entries too. Two host guards are no findings:
    ``vocab.check_row_ceiling`` returns at once for a CUDA tensor, and
    ``PiperPipeline.build_state_stream`` reads ``rows_seen`` only once its
    row bound passes ``MAX_ROWS``;
  * **an audit that fails** (JX302, error);
  * **in-place train steps** (JX310, warning), the counterpart of the
    reference's donation audit: a train step (``train/steps.py``'s
    ``make_train_step`` and the DLRM's ``make_tabular_train_step``) must
    keep the storage of its parameters and AdamW moments across a step,
    which :func:`audit_train_steps` checks by ``data_ptr``.

The reference's jaxpr call-primitive list has no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import _build

PLAN_COMPILER = "src/repro_torch/core/plan_compiler.py"
# aten ops that launch no device work: allocations and views are left out
# of the count (views by their schema's is_view)
_FREE = frozenset({"empty", "empty_strided", "empty_like", "detach", "lift_fresh", "alias"})
# aten ops that wait for the device to hand a value to the host
_SYNC = frozenset({"_local_scalar_dense", "equal", "is_nonzero", "nonzero", "masked_select"})
# what a recorded scalar read of a fake tensor (FakeTensorMode) returns
_SCALAR = {"_local_scalar_dense": 0, "equal": False, "is_nonzero": False}


@dataclasses.dataclass
class Dispatches:
    """What one call dispatched: aten ops by name (outside kernel entries),
    kernel entries by name, and host synchronisations (op, device)."""

    ops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    entries: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    syncs: list = dataclasses.field(default_factory=list)

    @property
    def total(self) -> int:
        return sum(self.ops.values()) + sum(self.entries.values())


def _is_sync(func, args, kwargs, devices) -> str | None:
    """The device of a host synchronisation this op makes, or None."""
    name = func.overloadpacket.__name__
    tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
    if name in _SYNC:
        dev = next((t.device for t in tensors), None)
    elif name in ("_to_copy", "copy_"):
        # a copy to the host from a device tensor
        if name == "_to_copy":
            src, dst = tensors[0].device, torch.device(kwargs.get("device") or tensors[0].device)
        else:
            dst, src = tensors[0].device, tensors[1].device
        dev = src if dst.type == "cpu" and src.type != "cpu" else None
    else:
        return None
    return str(dev) if dev is not None and dev.type in devices else None


class _Mode(TorchDispatchMode):
    def __init__(self, record: Dispatches, devices):
        super().__init__()
        self.record, self.devices, self.depth = record, devices, 0

    @contextlib.contextmanager
    def entry(self, name: str):
        if self.depth == 0:
            self.record.entries[name] += 1
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth == 0:
            name = func.overloadpacket.__name__
            dev = _is_sync(func, args, kwargs, self.devices)
            if dev is not None:
                self.record.syncs.append((name, dev))
                if name in _SCALAR and any(type(a).__name__ == "FakeTensor" for a in args):
                    return _SCALAR[name]  # a fake tensor has no value: the read is recorded
            if not (func.is_view or name in _FREE):
                self.record.ops[name] += 1
        return func(*args, **kwargs)


def trace_dispatches(fn, *args, sync_devices=("cuda",)) -> Dispatches:
    """Run ``fn(*args)`` on this thread and record what it dispatched (see
    :class:`Dispatches`). A host synchronisation counts for a tensor whose
    device type is in ``sync_devices``."""
    record = Dispatches()
    mode = _Mode(record, tuple(sync_devices))
    prev = _build._audit.hook
    _build._audit.hook = mode.entry
    try:
        with mode:
            fn(*args)
    finally:
        _build._audit.hook = prev
    return record


def count_dispatches(fn, *args) -> int:
    """Dispatches of ``fn(*args)``: aten ops (views and allocations left
    out), a hand-kernel entry counting as ONE, not descended into."""
    return trace_dispatches(fn, *args).total


# --------------------------------------------------------------------- #
# the compiled plan's hot path
# --------------------------------------------------------------------- #
def utf8_rows(schema, rows: int, seed: int = 0) -> bytes:
    """``rows`` Criteo-style utf8 rows of ``schema``: a label, decimal dense
    fields (some empty), hex sparse fields (some empty), tab-separated."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        fields = [str(int(rng.integers(0, 2)))]
        fields += ["" if rng.random() < 0.1 else str(int(v))
                   for v in rng.integers(-3, 5000, schema.n_dense)]
        fields += ["" if rng.random() < 0.1 else format(int(v), "08x")
                   for v in rng.integers(0, 2**32, schema.n_sparse, dtype=np.uint64)]
        out.append("\t".join(fields))
    return ("\n".join(out) + "\n").encode()


@dataclasses.dataclass
class RouteInputs:
    state: object
    vocabulary: object
    batch: object
    byte_buf: torch.Tensor
    max_rows: int


def route_inputs(compiled, rows: int, seed: int = 0) -> RouteInputs:
    """Seeded inputs of each dispatch of ``compiled`` on its device: a
    fresh state, an all-zero vocabulary, a decoded batch and its ``rows``
    utf8 rows. The batch is decoded here, outside any audit."""
    from repro_torch.core import schema as schema_lib
    from repro_torch.core import vocab as vocab_lib
    from repro_torch.kernels.decode_utf8 import ops as decode_ops

    sch, dev = compiled.schema, compiled.device
    buf = torch.from_numpy(np.frombuffer(utf8_rows(sch, rows, seed), np.uint8).copy()).to(dev)
    label, dense, sparse, valid = decode_ops.decode(
        buf, sch.field_is_hex(), n_fields=sch.n_fields, max_rows=rows, n_dense=sch.n_dense,
        n_sparse=sch.n_sparse)
    n = max(compiled.n_vocab_columns, 1)
    vocabulary = vocab_lib.Vocabulary(
        table=torch.zeros((n, compiled.vocab_range), dtype=torch.int32, device=dev),
        sizes=torch.zeros((n,), dtype=torch.int32, device=dev))
    return RouteInputs(compiled.init_state(), vocabulary,
                       schema_lib.TabularBatch(label=label, dense=dense, sparse=sparse,
                                               valid=valid), buf, rows)


def hot_path_calls(compiled, inputs: RouteInputs) -> dict:
    """The reference's audited entry points as zero-argument calls:
    ``vocab_step``, ``transform``, and ``vocab_step_bytes`` and
    ``transform_bytes`` where the plan takes the bytes-in route."""
    i = inputs
    calls = {"vocab_step": lambda: compiled.vocab_step(i.state, i.batch),
             "transform": lambda: compiled.transform(i.vocabulary, i.batch)}
    if compiled.decode_vocab_dispatch:
        calls["vocab_step_bytes"] = lambda: compiled.vocab_step_bytes(
            i.state, i.byte_buf, max_rows=i.max_rows)
    if compiled.decode_xform_dispatch:
        calls["transform_bytes"] = lambda: compiled.transform_bytes(
            i.vocabulary, i.byte_buf, max_rows=i.max_rows)
    return calls


def route_calls(compiled, inputs: RouteInputs) -> dict:
    """One chunk of each ``static_routes`` dispatch as a zero-argument call,
    as the engine makes it: ``vocab`` and ``xform`` on the decoded batch;
    ``decode_vocab`` and ``decode_xform`` from the utf8 bytes, on the
    bytes-in kernel or as decode and then the decoded-input half."""
    from repro_torch.kernels.decode_utf8 import ops as decode_ops

    i, sch = inputs, compiled.schema

    def decoded():
        label, dense, sparse, valid = decode_ops.decode(
            i.byte_buf, sch.field_is_hex(), n_fields=sch.n_fields, max_rows=i.max_rows,
            n_dense=sch.n_dense, n_sparse=sch.n_sparse)
        return type(i.batch)(label=label, dense=dense, sparse=sparse, valid=valid)

    calls = hot_path_calls(compiled, inputs)
    return {
        "vocab": calls["vocab_step"],
        "xform": calls["transform"],
        "decode_vocab": calls.get("vocab_step_bytes")
        or (lambda: compiled.vocab_step(i.state, decoded())),
        "decode_xform": calls.get("transform_bytes")
        or (lambda: compiled.transform(i.vocabulary, decoded())),
    }


def observe_routes(compiled, *, rows: int = 64, seed: int = 0) -> dict:
    """Kernel entries one chunk of each dispatch of ``compiled`` calls, by
    dispatch (``kernelcheck`` holds them to the route labels)."""
    inputs = route_inputs(compiled, rows, seed)
    return {name: trace_dispatches(call).entries
            for name, call in route_calls(compiled, inputs).items()}


@contextlib.contextmanager
def _sync_debug(device):
    """``torch.cuda.set_sync_debug_mode("error")`` on a CUDA device: a call
    that synchronises the host with the card raises."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _jx(rule, severity, obj, message, file=PLAN_COMPILER) -> Finding:
    return Finding(rule=rule, severity=severity, pass_name="launches", file=file, line=0,
                   obj=obj, message=message)


def audit_calls(calls: dict, device, *, context: str) -> tuple[list[Finding], dict]:
    """Run each call once under the audit (and, on a card, sync debug
    mode): JX301 for a host synchronisation, JX302 for a call that fails.
    Returns the findings and, per call, its :class:`Dispatches`."""
    out, traced = [], {}
    for name, call in calls.items():
        obj = f"{context}/{name}"
        try:
            with _sync_debug(device):
                record = trace_dispatches(call)
        except RuntimeError as e:
            if "synchroniz" in str(e):
                out.append(_jx("JX301", "error", obj,
                               f"host synchronisation on the hot path (sync debug mode): {e}"))
            else:
                out.append(_jx("JX302", "error", obj, f"audit failed: {type(e).__name__}: {e}"))
            continue
        except Exception as e:  # an audit that fails is itself a finding
            out.append(_jx("JX302", "error", obj, f"audit failed: {type(e).__name__}: {e}"))
            continue
        traced[name] = record
        for op, dev in sorted(set(record.syncs)):
            out.append(_jx("JX301", "error", obj,
                           f"host synchronisation {op!r} of a {dev} tensor on the hot path "
                           f"({record.syncs.count((op, dev))}x) — a device → host wait per "
                           "chunk"))
    return out, traced


def audit_compiled_plan(compiled, *, rows: int = 256, max_rows: int | None = None,
                        context: str = "plan") -> tuple[list[Finding], dict[str, int]]:
    """Run every hot-path entry point once; → (findings, dispatch counts).
    ``max_rows`` (default ``rows``) is the bytes-in calls' row capacity."""
    try:
        inputs = route_inputs(compiled, rows)
    except Exception as e:  # no inputs: the audit itself failed
        return [_jx("JX302", "error", f"{context}/inputs",
                    f"audit failed: {type(e).__name__}: {e}")], {}
    if max_rows is not None:
        inputs.max_rows = max_rows
    found, traced = audit_calls(hot_path_calls(compiled, inputs), compiled.device,
                                context=context)
    return found, {f"{context}/{name}": r.total for name, r in traced.items()}


def check_fused_reduction(*, rows: int = 256, device="cpu") -> tuple[list[Finding], dict]:
    """The no-materialization property: each fused route dispatches
    strictly fewer per chunk than its unfused twin (the plain chain)."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import plan_compiler
    from repro_torch.core import schema as schema_lib

    schema = schema_lib.CRITEO
    plan = plan_lib.criteo_default(schema)
    out, stats = [], {}
    counts = {}
    for label, hints in (("fused", {"fused": True, "fused_vocab": True}),
                         ("unfused", {"fused": False, "fused_vocab": False})):
        compiled = plan_compiler.compile_plan(plan, schema, device=device, **hints)
        calls = hot_path_calls(compiled, route_inputs(compiled, rows))
        for name in ("vocab_step", "transform"):
            counts[label, name] = trace_dispatches(calls[name]).total
            stats[f"{label}/{name}"] = counts[label, name]
    for name in ("vocab_step", "transform"):
        fused, unfused = counts["fused", name], counts["unfused", name]
        if fused >= unfused:
            out.append(_jx("JX303", "error", f"criteo-5k/{name}",
                           f"fused route dispatches {fused} per chunk vs {unfused} unfused — "
                           "fusion must strictly reduce the count"))
    return out, stats


# --------------------------------------------------------------------- #
# in-place train steps (the donation audit's counterpart)
# --------------------------------------------------------------------- #
def step_keeps_storage(step, params, opt_state: dict) -> list[str]:
    """Run ``step()`` once; the names of what lost its storage: parameters
    (``params()``'s leaves), AdamW first and second moments, the step
    count. The trees are read again after the step."""
    from repro_torch.train.tree import leaves

    def storage() -> dict[str, list[int]]:
        groups = {"params": leaves(params()), "m": leaves(opt_state["m"]),
                  "v": leaves(opt_state["v"]), "step": [opt_state["step"]]}
        return {k: [t.data_ptr() for t in v] for k, v in groups.items()}

    before = storage()
    step()
    after = storage()
    return [f"{k}[{i}]" for k in before
            for i, (a, b) in enumerate(zip(before[k], after[k])) if a != b]


def train_step_calls(device) -> dict:
    """One step of each train step at SMOKE size on ``device``, as
    ``(step, parameter tree getter, opt_state)``: the DLRM's
    ``make_tabular_train_step`` over Piper's batch layout and the LM's
    ``make_train_step`` (gemma-2b SMOKE, 2 microbatches)."""
    from repro_torch import configs
    from repro_torch.configs import piper_dlrm
    from repro_torch.models import dlrm, lm
    from repro_torch.train import optimizer, steps

    device = torch.device(device)
    rng = np.random.default_rng(0)
    cfg = piper_dlrm.SMOKE.model
    model = dlrm.DLRM(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
    opt = optimizer.adamw_init(model.params_tree())
    batch = {
        "label": torch.from_numpy(rng.integers(0, 2, 64).astype(np.int32)).to(device),
        "dense": torch.from_numpy(rng.random((64, cfg.n_dense), np.float32)).to(device),
        "sparse": torch.from_numpy(
            rng.integers(0, cfg.vocab_range, (64, cfg.n_sparse)).astype(np.int32)).to(device),
    }
    dlrm_step = steps.make_tabular_train_step(dlrm.loss, optimizer.AdamWConfig())
    out = {"dlrm": (lambda: dlrm_step(model, opt, batch), model.params_tree, opt)}
    lm_model = lm.LM(configs.get_smoke("gemma-2b"), attn_impl="chunked", device=device)
    params = steps.trainable(lm_model.init(torch.Generator(device).manual_seed(0)))
    lm_opt = optimizer.adamw_init(params)
    tokens = torch.from_numpy(
        rng.integers(0, lm_model.cfg.vocab_size, (4, 32)).astype(np.int32)).to(device)
    lm_step = steps.make_train_step(lm_model, optimizer.AdamWConfig(), microbatches=2)
    out["lm"] = (lambda: lm_step(params, lm_opt, {"tokens": tokens}), lambda: params, lm_opt)
    return out


def audit_train_steps(device="cpu") -> list[Finding]:
    """JX310 for each of :func:`train_step_calls`."""
    out = []
    try:
        calls = train_step_calls(device)
    except Exception as e:  # no step to audit: the audit itself failed
        return [_jx("JX302", "error", "train/steps", f"audit failed: {type(e).__name__}: {e}",
                    file="src/repro_torch/train/steps.py")]
    for name, (step, params, opt) in calls.items():
        moved = step_keeps_storage(step, params, opt)
        if moved:
            out.append(_jx("JX310", "warning", f"{name}/train_step",
                           f"the {name} train step reallocated {moved[:6]} "
                           f"({len(moved)} in all): its parameters and AdamW state must update "
                           "in place", file="src/repro_torch/train/steps.py"))
    return out


def run(root: str, *, device=None) -> tuple[list[Finding], dict[str, int]]:
    """The whole pass on the stock configuration, on ``device`` (the CPU by
    default): criteo-5k's fused and bytes-in hot path at
    ``max_rows = 1 << 14``, the fused-reduction property and the train
    steps."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import plan_compiler
    from repro_torch.core import schema as schema_lib

    device = torch.device(device or "cpu")
    schema = schema_lib.CRITEO
    compiled = plan_compiler.compile_plan(
        plan_lib.criteo_default(schema), schema, device=device, fused=True, fused_vocab=True,
        fused_decode=True)
    findings, stats = audit_compiled_plan(compiled, max_rows=1 << 14, context="criteo-5k")
    reduction, reduction_stats = check_fused_reduction(device=device)
    stats.update(reduction_stats)
    findings += reduction
    findings += audit_train_steps(device)
    return findings, stats
