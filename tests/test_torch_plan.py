"""The port's plan IR and plan compiler (repro_torch.core.plan,
repro_torch.core.plan_compiler) against the JAX package's, on the same
plans and the same numpy inputs made from seeds:

  * every ``PlanError`` of tests/test_plan_errors.py gives the same message
    in both packages;
  * grouping, vocab rows, routes and bytes-in admissibility agree for
    ``criteo_default``, ``crossed_criteo``, a modulus-only column and a
    vocab-range override;
  * ``CompiledPlan.vocab_step``/``transform`` equal the reference's on
    random batches, with ``use_kernels`` on and off (the reference's Pallas
    kernels in interpret mode, at one shape each), for random dense
    recipes and for a plan with no canonical dense group;
  * the 400-row pipeline through ``crossed_criteo``, utf8 and binary, with
    and without the count plane, and the ``fused_small.npz`` digest with
    ``use_kernels=True``.

Integers are compared bit for bit, dense values at rtol 1e-6. On the CPU
every kernel wrapper of the port takes its plain version.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import plan as jplan
from repro.core import plan_compiler as jcomp
from repro.core import schema as jschema
from repro.core import vocab as jvocab
from repro.data import loader as jloader
from repro.data import synth as jsynth
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import plan as tplan
from repro_torch.core import plan_compiler as tcomp
from repro_torch.core import schema as tschema
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth as tsynth

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fused_small.npz")
JSMALL = jschema.TableSchema(n_dense=4, n_sparse=5, vocab_range=101)
TSMALL = tschema.TableSchema(n_dense=4, n_sparse=5, vocab_range=101)
ROWS = 128  # one batch shape, so each interpret-mode Pallas kernel compiles once


# --------------------------------------------------------------------- #
# one plan, built in both packages
# --------------------------------------------------------------------- #
CANON = "canonical"  # the SPARSE_CANONICAL chain of either package


def _build(lib, cols):
    """cols: (kind, source, ops, name) with ops a list of (op, params) or
    CANON → that package's PreprocPlan."""
    specs = []
    for kind, source, ops, name in cols:
        chain = lib.SPARSE_CANONICAL if ops == CANON else tuple(lib.op(o, **p) for o, p in ops)
        specs.append(lib.ColumnSpec(kind=kind, source=source, ops=chain, name=name))
    return lib.PreprocPlan(columns=tuple(specs))


def _vocab_cols(ranges):
    return [("sparse", j, [("Modulus", {"range": r}), ("GenVocab", {}), ("ApplyVocab", {})], "")
            for j, r in enumerate(ranges)]


N2Z = [("Neg2Zero", {})]
ERROR_CASES = {
    "empty": [],
    "duplicate_names": [("dense", 0, N2Z, "x"), ("dense", 1, N2Z, "x")],
    "unknown_kind": [("ragged", 0, N2Z, "")],
    "unknown_source_sparse": [("sparse", 99, CANON, "")],
    "unknown_source_dense": [("dense", -1, N2Z, "")],
    "unknown_op": [("dense", 0, [("Sqrt", {})], "")],
    "domain_dense": [("dense", 0, [("Modulus", {})], "")],
    "domain_sparse": [("sparse", 0, [("Logarithm", {})], "")],
    "unknown_param": [("dense", 0, [("Neg2Zero", {"gain": 2})], "")],
    "decode_after_compute": [("sparse", 0, [("Modulus", {}), ("FillMissing", {})], "")],
    "hashcross_not_first": [("sparse", (0, 1), [("Modulus", {}), ("HashCross", {})], "")],
    "hashcross_needs_pair": [("sparse", 0, [("HashCross", {}), ("Modulus", {})], "")],
    "modulus_twice": [("sparse", 0, [("Modulus", {}), ("Modulus", {})], "")],
    "genvocab_twice": [("sparse", 0, [("Modulus", {}), ("GenVocab", {}), ("GenVocab", {})], "")],
    "genvocab_needs_modulus": [("sparse", 0, [("GenVocab", {})], "")],
    "applyvocab_needs_genvocab": [("sparse", 0, [("Modulus", {}), ("ApplyVocab", {})], "")],
    "modulus_range_zero": [("sparse", 0, [("Modulus", {"range": 0})], "")],
    "modulus_range_float": [("sparse", 0, [("Modulus", {"range": 2.5})], "")],
    "clip_order": [("dense", 0, [("Clip", {"lo": 5.0, "hi": 1.0})], "")],
    "minmax_missing_hi": [("dense", 0, [("MinMaxScale", {"lo": 0.0})], "")],
    "bucketize_empty": [("dense", 0, [("Bucketize", {"boundaries": ()})], "")],
    "bucketize_decreasing": [("dense", 0, [("Bucketize", {"boundaries": (3.0, 1.0)})], "")],
    "bucketize_repeated": [("dense", 0, [("Bucketize", {"boundaries": (1.0, 1.0)})], "")],
    "pair_needs_hashcross": [("sparse", (0, 1), [("Modulus", {})], "")],
    "vocab_ranges_disagree": _vocab_cols([7, 8]),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_plan_errors_match_reference(case):
    cols = ERROR_CASES[case]
    with pytest.raises(jcomp.PlanError) as jerr:
        jcomp.validate_plan(_build(jplan, cols), JSMALL)
    with pytest.raises(tcomp.PlanError) as terr:
        tcomp.validate_plan(_build(tplan, cols), TSMALL)
    assert str(terr.value) == str(jerr.value)
    assert isinstance(terr.value, ValueError)


@pytest.mark.parametrize("kind,op_name", [("sparse", "ApplyVocab"), ("dense", "Hex2Int")])
def test_eval_unhandled_op_matches_reference(kind, op_name):
    jc = jcomp.compile_plan(jplan.criteo_default(JSMALL), JSMALL, fused=False)
    tc = tcomp.compile_plan(tplan.criteo_default(TSMALL), TSMALL, device="cpu", fused=False)
    name = f"_eval_{kind}"
    with pytest.raises(jcomp.PlanError) as jerr:
        getattr(jc, name)(jnp.zeros((4, 1), jnp.int32), (jplan.op(op_name),))
    with pytest.raises(tcomp.PlanError) as terr:
        getattr(tc, name)(torch.zeros((4, 1), dtype=torch.int32), (tplan.op(op_name),))
    assert str(terr.value) == str(jerr.value)


def test_plan_ir_matches_reference():
    """The same dataclasses, registry, canonical chains and describe()."""
    assert list(tplan.REGISTRY) == list(jplan.REGISTRY)
    for name, jdef in jplan.REGISTRY.items():
        tdef = tplan.REGISTRY[name]
        assert (tdef.domain, tdef.stage, tdef.params) == (jdef.domain, jdef.stage, jdef.params)
    assert [str(o) for o in tplan.SPARSE_CANONICAL] == [str(o) for o in jplan.SPARSE_CANONICAL]
    assert [str(o) for o in tplan.DENSE_CANONICAL] == [str(o) for o in jplan.DENSE_CANONICAL]
    assert tplan.op("Bucketize", boundaries=[0, 10]) == tplan.OpSpec(
        "Bucketize", (("boundaries", (0, 10)),))
    for jp, tp in ((jplan.criteo_default(), tplan.criteo_default()),
                   (jplan.crossed_criteo(), tplan.crossed_criteo())):
        assert tp.describe() == jp.describe()
        assert interop.plan_from_reference(jp) == tp
        assert hash(tp) == hash(interop.plan_from_reference(jp))


# --------------------------------------------------------------------- #
# grouping and routes
# --------------------------------------------------------------------- #
ROUTE_OF = {"unfused": "unfused", "xla": "xla", "fused/vmem": "fused/device",
            "fused/hbm": "fused/device"}


def _small(lib):
    return JSMALL if lib is jplan else TSMALL


def _structure_plans():
    crossed = lambda lib: lib.crossed_criteo(  # noqa: E731
        _small(lib), crosses=((0, 1), (2, 3)), bucket_cols=(0, 2))
    modulus_only = [
        ("sparse", 0, [("Modulus", {"range": 1000}), ("GenVocab", {}), ("ApplyVocab", {})], ""),
        ("sparse", 1, [("Modulus", {})], ""),
        ("dense", 0, [("FillMissing", {}), ("Neg2Zero", {}), ("Logarithm", {})], ""),
    ]
    override = _vocab_cols([2_000_000] * 5) + [
        ("dense", 0, [("Neg2Zero", {}), ("Logarithm", {})], "")]
    return {
        "criteo_default": lambda lib: lib.criteo_default(_small(lib)),
        "crossed_criteo": crossed,
        "modulus_only": lambda lib: _build(lib, modulus_only),
        "range_override": lambda lib: _build(lib, override),
    }


def _structure(c, route_of=lambda r: r):
    return {
        "groups": [(g.kind, tuple(str(o) for o in g.signature), g.out_slots, g.sources,
                    route_of(g.route)) for g in c.groups],
        "n_out": (c.n_dense_out, c.n_sparse_out),
        "vocab": (c.n_vocab_columns, c.vocab_range, c._vocab_sources),
        "apply": (c._apply_slots, c._apply_sources, c._apply_vocab_rows),
        "dense": (c._fused_dense_slots, c._fused_dense_sources),
        "dispatch": (c._fused_dispatch, c._fused_vocab_dispatch,
                     c.decode_vocab_dispatch, c.decode_xform_dispatch),
        "routes": (route_of(c.xform_route), route_of(c.vocab_route)),
    }


@pytest.mark.parametrize("hints", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(_structure_plans()))
def test_grouping_and_routes_match_reference(name, hints):
    make = _structure_plans()[name]
    kw = dict(fused=hints, fused_vocab=hints, fused_decode=hints, use_kernels=not hints)
    jc = jcomp.compile_plan(make(jplan), JSMALL, **kw)
    tc = tcomp.compile_plan(make(tplan), TSMALL, device="cpu", **kw)
    want = _structure(jc, lambda r: ROUTE_OF.get(r, r))
    # the reference's loop-① route names a VMEM tier (or its XLA fallback)
    want["routes"] = (want["routes"][0], "fused/device" if jc._fused_vocab_dispatch else "unfused")
    assert _structure(tc) == want
    assert tc.decode_vocab_route == ("bytes/device" if jc.decode_vocab_dispatch else "decoded")
    assert tc.decode_xform_route == (
        "bytes/device" if jc.decode_xform_dispatch else "decoded")
    assert "CompiledPlan:" in tc.describe()


def test_crossed_plan_structure():
    c = tcomp.compile_plan(tplan.crossed_criteo(), tschema.CRITEO, device="cpu",
                           fused=False, use_kernels=True, fused_decode=True)
    assert (c.n_vocab_columns, c.n_sparse_out, c.n_dense_out) == (27, 27, 13)
    assert tuple(c.init_state().first_pos.shape) == (27, 5000)
    # a crossed plan is not the identity over the wire layout: no bytes-in
    assert (c.decode_vocab_route, c.decode_xform_route) == ("decoded", "decoded")
    assert "HashCross" in c.describe()


# --------------------------------------------------------------------- #
# the compiled halves on random batches
# --------------------------------------------------------------------- #
def _batch(seed):
    table = jsynth.generate_binary(jsynth.SynthConfig(
        schema=JSMALL, rows=ROWS, seed=seed, sparse_pool=64))
    rng = np.random.default_rng(seed)
    valid = rng.random(ROWS) < 0.85
    dense = table["dense"].copy()
    dense[0] = [-(2**31), 2**31 - 1, -1, 0]  # int32 extremes
    jb = jschema.TabularBatch(label=jnp.asarray(table["label"]), dense=jnp.asarray(dense),
                              sparse=jnp.asarray(table["sparse"]), valid=jnp.asarray(valid))
    tb = tschema.TabularBatch(label=torch.from_numpy(table["label"]),
                              dense=torch.from_numpy(dense),
                              sparse=torch.from_numpy(table["sparse"]),
                              valid=torch.from_numpy(valid))
    return jb, tb


def _same_state(t, j):
    np.testing.assert_array_equal(t.first_pos.numpy(), np.asarray(j.first_pos))
    assert int(t.rows_seen) == int(j.rows_seen)
    if j.counts is not None:
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


def _same_out(t, j):
    np.testing.assert_array_equal(t.label.numpy(), np.asarray(j.label))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.sparse.numpy(), np.asarray(j.sparse))
    assert t.dense.dtype == torch.float32
    np.testing.assert_allclose(t.dense.numpy(), np.asarray(j.dense), rtol=1e-6)


def _run_halves(jp, tp, use_kernels, counts, seeds=(1, 2), reference_kernels=None):
    """Two batches through loop ① of each package's compiled plan, then
    both batches through loop ②; state and outputs compared. The reference
    runs its kernels too unless ``reference_kernels`` says otherwise."""
    if reference_kernels is None:
        reference_kernels = use_kernels
    jc = jcomp.compile_plan(jp, JSMALL, fused=False, fused_vocab=False,
                            use_kernels=reference_kernels, track_counts=counts)
    tc = tcomp.compile_plan(tp, TSMALL, device="cpu", fused=False, fused_vocab=False,
                            use_kernels=use_kernels, track_counts=counts)
    js, ts = jc.init_state(), tc.init_state()
    batches = [_batch(s) for s in seeds]
    for jb, tb in batches:
        js, ts = jc.vocab_step(js, jb), tc.vocab_step(ts, tb)
        _same_state(ts, js)
    jv, tv = jvocab.finalize(js), tvocab.finalize(ts)
    np.testing.assert_array_equal(tv.table.numpy(), np.asarray(jv.table))
    for jb, tb in batches:
        _same_out(tc.transform(tv, tb), jc.transform(jv, jb))
    return tc


@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["ops", "kernels"])
@pytest.mark.parametrize("name", ["criteo_default", "crossed_criteo"])
def test_compiled_halves_match_reference(name, use_kernels, counts):
    make = _structure_plans()[name]
    _run_halves(make(jplan), make(tplan), use_kernels, counts)


_DENSE_RECIPES = {
    "clip": [("Clip", {"lo": -5.0, "hi": 50.0})],
    "minmax": [("MinMaxScale", {"lo": 0.0, "hi": 100.0})],
    "bucketize": [("Bucketize", {"boundaries": (0.0, 10.0, 100.0)})],
    "clip_log": [("Clip", {"lo": 0.0, "hi": 1000.0}), ("Logarithm", {})],
    "n2z_log_clip": [("Neg2Zero", {}), ("Logarithm", {}), ("Clip", {"lo": 0.0, "hi": 3.0})],
}


@pytest.mark.parametrize("use_kernels", [False, True], ids=["ops", "kernels"])
@pytest.mark.parametrize("seed", range(4))
def test_random_dense_recipes_match_reference(seed, use_kernels):
    """Dense columns 0-1 canonical (the kernel-dispatched group, one shape),
    columns 2-3 random recipes, plus crossed sparse columns: grouping,
    several routes and the column scatter, against the reference."""
    rng = np.random.default_rng(seed)
    names = list(_DENSE_RECIPES)
    picks = [names[i] for i in rng.integers(0, len(names), size=2)]
    cols = [("dense", i, [("Neg2Zero", {}), ("Logarithm", {})], f"d{i}") for i in (0, 1)]
    cols += [("dense", 2 + k, _DENSE_RECIPES[p], f"d{2 + k}_{p}") for k, p in enumerate(picks)]
    order = rng.permutation(len(cols))  # plan order is output order
    cols = [cols[i] for i in order]
    cols += [("sparse", j, CANON, f"s{j}") for j in range(5)]
    cols += [("sparse", (1, 3), [("HashCross", {}), ("Modulus", {}), ("GenVocab", {}),
                                 ("ApplyVocab", {})], "x13")]
    _run_halves(_build(jplan, cols), _build(tplan, cols), use_kernels, counts=False,
                seeds=(seed + 10,))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["ops", "kernels"])
def test_no_canonical_dense_routes_unfused(use_kernels):
    """Every dense column bucketized: the fused hint is on but there is no
    dense half for the fused kernel, so the vocab-apply group runs unfused
    (and says so), with the reference's outputs. The reference's own
    use_kernels route fails here (its dense Pallas kernel is handed a
    zero-width block), so it runs its plain chain."""
    jp = jplan.crossed_criteo(JSMALL, crosses=(), bucket_cols=tuple(range(4)))
    tp = tplan.crossed_criteo(TSMALL, crosses=(), bucket_cols=tuple(range(4)))
    tc = _run_halves(jp, tp, use_kernels, counts=False, reference_kernels=False)
    hinted = tcomp.compile_plan(tp, TSMALL, device="cpu", fused=True, use_kernels=use_kernels)
    assert not hinted._fused_dispatch and hinted.xform_route == "unfused"
    assert {g.route for g in hinted.groups if g.kind == "sparse"} == {"unfused"}
    assert tc.xform_route == "unfused"


def test_standalone_canonical_dense_group_matches_reference():
    """A canonical dense group with no vocab-apply group to share runs the
    (kernel-dispatched) dense pass on its own; GenVocab-only columns still
    build state and emit their modded values."""
    cols = [("dense", i, [("Neg2Zero", {}), ("Logarithm", {})], "") for i in (0, 1)]
    cols += [("dense", i, [("Clip", {"lo": 0.0, "hi": 9.0})], "") for i in (2, 3)]
    cols += [("sparse", j, [("Modulus", {}), ("GenVocab", {})], "") for j in range(3)]
    cols += [("sparse", j, [("Modulus", {})], "") for j in (3, 4)]
    tc = _run_halves(_build(jplan, cols), _build(tplan, cols), True, counts=False)
    assert [g.route for g in tc.groups if g.kind == "dense"] == ["xla", "xla"]


@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
def test_plan_without_vocab_columns_runs_kernels(counts):
    """No GenVocab column: the state has no rows, the GenVocab wrapper only
    advances rows_seen, and both routes agree. (The reference's use_kernels
    route fails here: its Pallas kernel is handed a zero-row state.)"""
    cols = [("dense", i, [("Neg2Zero", {}), ("Logarithm", {})], "") for i in range(4)]
    cols += [("sparse", j, [("Modulus", {"range": 7})], "") for j in range(5)]
    outs = []
    for use_kernels in (False, True):
        tc = tcomp.compile_plan(_build(tplan, cols), TSMALL, device="cpu", fused=False,
                                use_kernels=use_kernels, track_counts=counts)
        _, tb = _batch(5)
        state = tc.vocab_step(tc.init_state(), tb)
        assert tuple(state.first_pos.shape) == (0, 101)
        assert int(state.rows_seen) == int(tb.valid.sum())
        outs.append(tc.transform(tvocab.finalize(state), tb))
    for f in ("label", "dense", "sparse", "valid"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f


# --------------------------------------------------------------------- #
# the engine, through the crossed plan
# --------------------------------------------------------------------- #
CHUNK_BYTES, MAX_ROWS = 32768, 256


def _feeds(criteo_small, fmt):
    buf, table, _ = criteo_small
    if fmt == "utf8":
        return lambda: jsynth.chunk_stream(buf, CHUNK_BYTES)
    flat = jloader.BinaryChunkFeed(table, 96).flat_chunks()
    chunks = [{k: v[i] for k, v in flat.items()} for i in range(len(flat["label"]))]
    return lambda: iter(chunks)


def _engine_kw(fmt, counts):
    return dict(chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, input_format=fmt,
                track_vocab_counts=counts)


@pytest.fixture(scope="module")
def reference_runs(criteo_small):
    """(fmt, counts) → the JAX engine's run through crossed_criteo on the
    plain chain, made once: numpy state, vocabulary and loop-② outputs."""
    runs = {}

    def run(fmt, counts):
        if (fmt, counts) not in runs:
            chunks = _feeds(criteo_small, fmt)
            pipe = JP.PiperPipeline(JP.PipelineConfig(
                plan=jplan.crossed_criteo(), use_fused_kernel=False, use_fused_vocab=False,
                **_engine_kw(fmt, counts)))
            state = pipe.build_state_stream(chunks())
            vocab = jvocab.finalize_topk(state, 50) if counts else jvocab.finalize(state)
            outs = [{f: np.asarray(getattr(o, f)) for f in ("label", "dense", "sparse", "valid")}
                    for o in pipe.transform_stream(vocab, chunks())]
            runs[fmt, counts] = (
                np.asarray(state.first_pos), int(state.rows_seen),
                None if state.counts is None else np.asarray(state.counts),
                np.asarray(vocab.table), outs)
        return runs[fmt, counts]

    return run


@pytest.mark.parametrize("use_kernels", [False, True], ids=["ops", "kernels"])
@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_crossed_pipeline_matches_reference(criteo_small, reference_runs, fmt, counts,
                                           use_kernels):
    first_pos, rows_seen, counts_np, table, outs = reference_runs(fmt, counts)
    chunks = _feeds(criteo_small, fmt)
    pipe = TP.PiperPipeline(TP.PipelineConfig(
        device="cpu", plan=tplan.crossed_criteo(), use_kernels=use_kernels,
        use_fused_decode=True, **_engine_kw(fmt, counts)))
    assert not pipe._bytes_vocab and not pipe._bytes_xform  # not identity-layout
    state = pipe.build_state_stream(chunks())
    assert tuple(state.first_pos.shape) == (27, 5000)
    np.testing.assert_array_equal(state.first_pos.numpy(), first_pos)
    assert int(state.rows_seen) == rows_seen == 400
    if counts:
        np.testing.assert_array_equal(state.counts.numpy(), counts_np)
    vocab = tvocab.finalize_topk(state, 50) if counts else tvocab.finalize(state)
    np.testing.assert_array_equal(vocab.table.numpy(), table)
    got = list(pipe.transform_stream(vocab, chunks()))
    assert len(got) == len(outs)
    for t, j in zip(got, outs):
        for f in ("label", "sparse", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), j[f], err_msg=f)
        np.testing.assert_allclose(t.dense.numpy(), j["dense"], rtol=1e-6)
    step = pipe.frozen_transform(vocab)
    assert step.compiled is pipe.compiled


def _digest(label, sparse):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(label, np.int32).tobytes())
    h.update(np.ascontiguousarray(sparse, np.int32).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("plan", [None, "explicit"], ids=["default", "explicit_plan"])
def test_golden_digest_with_kernels(plan):
    """criteo_default through the compiled plan on the use_kernels route
    reproduces fused_small.npz."""
    g = np.load(GOLDEN)
    cb = int(g["chunk_bytes"])
    pipe = TP.PiperPipeline(TP.PipelineConfig(
        chunk_bytes=cb, max_rows_per_chunk=int(g["max_rows_per_chunk"]), device="cpu",
        use_kernels=True, plan=tplan.criteo_default() if plan else None))
    assert pipe.compiled.n_vocab_columns == 26
    assert (pipe.compiled.vocab_route, pipe.compiled.xform_route) == ("unfused", "unfused")
    outs = list(pipe.run_stream(lambda: tsynth.chunk_stream(g["buf"], cb)))
    label = np.concatenate([o.label[o.valid].numpy() for o in outs])
    dense = np.concatenate([o.dense[o.valid].numpy() for o in outs])
    sparse = np.concatenate([o.sparse[o.valid].numpy() for o in outs])
    np.testing.assert_array_equal(label, g["label"])
    np.testing.assert_array_equal(sparse, g["sparse"])
    np.testing.assert_allclose(dense, g["dense"], rtol=1e-6)
    assert _digest(label, sparse) == str(g["digest"])
