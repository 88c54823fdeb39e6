"""The port's two-loop engine (repro_torch.core.pipeline) on the CPU: the
fused_small.npz golden by digest, and equality with the JAX package's
PiperPipeline on the same 400-row dataset — utf8 and binary feeds, with
and without the count plane, every row of every chunk compared (padding
rows included)."""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import plan as jplan
from repro.core import vocab as jvocab
from repro.data import loader as jloader
from repro.data import synth as jsynth
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import vocab as tvocab
from repro_torch.data import loader as tloader
from repro_torch.data import synth as tsynth

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fused_small.npz")
CHUNK_BYTES, MAX_ROWS = 32768, 256


def _digest(label, sparse):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(label, np.int32).tobytes())
    h.update(np.ascontiguousarray(sparse, np.int32).tobytes())
    return h.hexdigest()


def test_golden_digest_on_cpu():
    g = np.load(GOLDEN)
    cb = int(g["chunk_bytes"])
    pipe = TP.PiperPipeline(TP.PipelineConfig(
        chunk_bytes=cb, max_rows_per_chunk=int(g["max_rows_per_chunk"]), device="cpu"))
    outs = list(pipe.run_stream(lambda: tsynth.chunk_stream(g["buf"], cb)))
    label = np.concatenate([o.label[o.valid].numpy() for o in outs])
    dense = np.concatenate([o.dense[o.valid].numpy() for o in outs])
    sparse = np.concatenate([o.sparse[o.valid].numpy() for o in outs])
    np.testing.assert_array_equal(label, g["label"])
    np.testing.assert_array_equal(sparse, g["sparse"])
    np.testing.assert_allclose(dense, g["dense"], rtol=1e-6)
    assert _digest(label, sparse) == str(g["digest"])


def _feeds(criteo_small, fmt):
    buf, table, _ = criteo_small
    if fmt == "utf8":
        return lambda: jsynth.chunk_stream(buf, CHUNK_BYTES)
    flat = jloader.BinaryChunkFeed(table, 96).flat_chunks()
    chunks = [{k: v[i] for k, v in flat.items()} for i in range(len(flat["label"]))]
    return lambda: iter(chunks)


def _configs(fmt, counts):
    kw = dict(chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, input_format=fmt,
              track_vocab_counts=counts)
    return JP.PipelineConfig(use_fused_kernel=False, **kw), TP.PipelineConfig(device="cpu", **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        for f in ("label", "sparse", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                          err_msg=f)
        np.testing.assert_allclose(t.dense.numpy(), np.asarray(j.dense), rtol=1e-6)


@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_matches_reference_pipeline(criteo_small, fmt, counts):
    jcfg, tcfg = _configs(fmt, counts)
    chunks = _feeds(criteo_small, fmt)
    jpipe, tpipe = JP.PiperPipeline(jcfg), TP.PiperPipeline(tcfg)
    jstate = jpipe.build_state_stream(chunks())
    tstate = tpipe.build_state_stream(chunks())
    np.testing.assert_array_equal(tstate.first_pos.numpy(), np.asarray(jstate.first_pos))
    assert int(tstate.rows_seen) == int(jstate.rows_seen) == 400
    if counts:
        np.testing.assert_array_equal(tstate.counts.numpy(), np.asarray(jstate.counts))
        jv, tv = jvocab.finalize_topk(jstate, 50), tvocab.finalize_topk(tstate, 50)
    else:
        jv, tv = jvocab.finalize(jstate), tvocab.finalize(tstate)
    np.testing.assert_array_equal(tv.table.numpy(), np.asarray(jv.table))
    _assert_batches_equal(list(tpipe.transform_stream(tv, chunks())),
                          list(jpipe.transform_stream(jv, chunks())))
    if not counts:
        _assert_batches_equal(list(tpipe.run_stream(chunks)), list(jpipe.run_stream(chunks)))


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_run_scan_equals_run_stream(criteo_small, fmt):
    buf, table, _ = criteo_small
    _, tcfg = _configs(fmt, False)
    pipe = TP.PiperPipeline(tcfg)
    if fmt == "utf8":
        chunks = list(tsynth.chunk_stream(buf, CHUNK_BYTES))
        stacked = np.stack(chunks)
    else:
        stacked = tloader.BinaryChunkFeed(table, 96).flat_chunks()
        chunks = [{k: v[i] for k, v in stacked.items()} for i in range(len(stacked["label"]))]
    stream = list(pipe.run_stream(lambda: iter(chunks)))
    scan = pipe.run_scan(stacked)
    assert scan.sparse.shape[0] == len(chunks)
    flat = TP.flatten_processed(scan)
    for f in ("label", "dense", "sparse", "valid"):
        assert torch.equal(getattr(flat, f), torch.cat([getattr(o, f) for o in stream])), f


def test_frozen_transform_serves_requests(criteo_small):
    """Requests of a few rows each, served with the frozen vocabulary, give
    the rows of the offline table; swapping the vocabulary takes effect."""
    buf, _, cfg = criteo_small
    _, tcfg = _configs("utf8", False)
    pipe = TP.PiperPipeline(tcfg)
    vocab = pipe.build_vocab_stream(tsynth.chunk_stream(buf, CHUNK_BYTES))
    table = [o for o in pipe.transform_stream(vocab, tsynth.chunk_stream(buf, CHUNK_BYTES))]
    offline = torch.cat([o.sparse[o.valid] for o in table])
    step = TP.FrozenVocabTransform(vocab, config=tcfg)
    assert step.config is tcfg and step.vocabulary is vocab
    row0 = 0
    for n, payload in zip((7, 1, 30), tsynth.request_payloads(buf, None, (7, 1, 30))):
        out = step(payload)
        assert torch.equal(out.sparse[out.valid], offline[row0:row0 + n])
        row0 += n
    zero = tvocab.Vocabulary(torch.zeros_like(vocab.table), vocab.sizes)
    step.swap_vocabulary(zero)
    assert int(step(payload).sparse.abs().sum()) == 0
    with pytest.raises(ValueError, match="PipelineConfig or a PiperPipeline"):
        TP.FrozenVocabTransform(vocab)


def test_build_state_stream_guards_ceiling(criteo_small, monkeypatch):
    """The host-side stream guard reads the true count and raises before
    the saturating kernels would drop rows (ceiling shrunk for the test)."""
    buf = criteo_small[0]
    monkeypatch.setattr(tvocab, "MAX_ROWS", 300)
    pipe = TP.PiperPipeline(TP.PipelineConfig(max_rows_per_chunk=256, device="cpu"))
    with pytest.raises(OverflowError, match="ceiling"):
        pipe.build_state_stream(tsynth.chunk_stream(buf, 4096))


@pytest.mark.parametrize("field,value", [("vocab_slab_range", 128)])
def test_unported_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TP.PipelineConfig(device="cpu", **{field: value})


def test_plan_must_be_a_port_plan():
    with pytest.raises(TypeError, match="PreprocPlan.*plan_from_reference"):
        TP.PipelineConfig(device="cpu", plan=object())


@pytest.mark.parametrize("field", ["use_kernels", "plan"])
def test_plan_and_use_kernels_match_reference(criteo_small, field):
    """The two fields run on the CPU, each against the JAX engine under the
    same setting: use_kernels=True (the per-op kernels' plain versions
    here, the Pallas kernels in interpret mode there) and a crossed,
    bucketized plan."""
    jkw, tkw = {"use_kernels": True}, {"use_kernels": True}
    if field == "plan":
        jkw = {"plan": jplan.crossed_criteo(bucket_cols=(0, 5))}
        tkw = {"plan": interop.plan_from_reference(jkw["plan"])}
    kw = dict(chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, input_format="binary")
    jpipe = JP.PiperPipeline(JP.PipelineConfig(use_fused_kernel=False, **kw, **jkw))
    tpipe = TP.PiperPipeline(TP.PipelineConfig(device="cpu", **kw, **tkw))
    chunks = _feeds(criteo_small, "binary")
    _assert_batches_equal(list(tpipe.run_stream(chunks)), list(jpipe.run_stream(chunks)))
    assert tpipe.compiled.n_sparse_out == jpipe.compiled.n_sparse_out


def test_config_checks():
    with pytest.raises(ValueError, match="input_format"):
        TP.PipelineConfig(device="cpu", input_format="csv")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        TP.PipelineConfig(device="meta")
    for hint in ("use_fused_kernel", "use_fused_vocab"):
        with pytest.raises(ValueError, match="needs device='cuda'"):
            TP.PipelineConfig(device="cpu", **{hint: True})
    cfg = TP.PipelineConfig(device="cpu")
    assert not cfg.fused_enabled and not cfg.fused_vocab_enabled
    off = dataclasses.replace(cfg, use_fused_kernel=False, use_fused_vocab=False)
    assert not off.fused_enabled and not off.fused_vocab_enabled


def test_binary_chunk_without_valid_is_all_valid(criteo_small):
    _, table, _ = criteo_small
    pipe = TP.PiperPipeline(TP.PipelineConfig(input_format="binary", device="cpu"))
    chunk = {k: table[k][:50] for k in ("label", "dense", "sparse")}
    state = pipe.vocab_step(pipe.init_state(), chunk)
    assert int(state.rows_seen) == 50
    jpipe = JP.PiperPipeline(JP.PipelineConfig(input_format="binary", use_fused_kernel=False))
    jstate = jpipe.vocab_step(jpipe.init_state(), {k: jnp.asarray(v) for k, v in chunk.items()})
    np.testing.assert_array_equal(state.first_pos.numpy(), np.asarray(jstate.first_pos))
