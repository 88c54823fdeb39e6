"""The port's row-wise CPU baseline (repro_torch.core.baseline) against the
JAX package's (repro.core.baseline) on the same inputs, function by
function, bit for bit: synthetic Criteo rows, the hostile rows of
tests/test_decode_fuzz.py (truncated final rows, empty fields, invalid
and overlong hex, overlong decimals, stray minus signs), 1, 2 and 4
threads, and the binary Config III path. Then the reference quickstart's
check on the port alone: the port's columnar engine on the CPU equals the
port's baseline (ordinals bit for bit, dense at rtol 1e-6), on a utf8 feed
and on its binary table."""

import dataclasses

import numpy as np
import pytest

from repro.core import baseline as jbase
from repro.core import schema as jschema
from repro.data import synth as jsynth
from repro_torch.core import baseline as tbase
from repro_torch.core import pipeline as TP
from repro_torch.core import schema as tschema
from repro_torch.data import loader as tloader
from repro_torch.data import synth as tsynth
from tests.test_decode_fuzz import _hostile_chunk

FIELDS = ("label", "dense", "sparse")


def _equal_tables(got, want):
    assert set(got) == set(want) == set(FIELDS)
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _inputs():
    """(name, utf8 buffer, port schema, reference schema) triples."""
    out = []
    for rows, seed in ((300, 0), (57, 1)):
        buf, _ = jsynth.make_dataset(jsynth.SynthConfig(rows=rows, seed=seed))
        out.append((f"synth{rows}", buf, tschema.CRITEO, jschema.CRITEO))
    for seed, (n_dense, n_sparse, n_rows, truncate) in enumerate(
            [(13, 26, 60, 0), (13, 26, 45, 7), (3, 5, 80, 1), (2, 3, 40, 30)]):
        buf = _hostile_chunk(seed, n_dense, n_sparse, n_rows, truncate)
        t = tschema.TableSchema(n_dense=n_dense, n_sparse=n_sparse, vocab_range=97)
        j = jschema.TableSchema(n_dense=n_dense, n_sparse=n_sparse, vocab_range=97)
        out.append((f"hostile{seed}", buf, t, j))
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("n_threads", [1, 2, 4])
@pytest.mark.parametrize("inp", INPUTS, ids=[i[0] for i in INPUTS])
def test_every_stage_matches_reference(inp, n_threads):
    """split_input_file, decode_rows_serial, positive_modulus,
    generate_vocab_thread, merge_sub_dictionaries, apply_vocab and
    concatenate, stage by stage on the same sub-files."""
    _, buf, tsch, jsch = inp
    subs = tbase.split_input_file(buf, n_threads)
    want_subs = jbase.split_input_file(buf, n_threads)
    assert len(subs) == len(want_subs)
    for g, w in zip(subs, want_subs):
        np.testing.assert_array_equal(g, w)
    decoded = [tbase.decode_rows_serial(s, tsch) for s in subs]
    for g, s in zip(decoded, want_subs):
        _equal_tables(g, jbase.decode_rows_serial(s, jsch))
    modded = [tbase.positive_modulus(p["sparse"], tsch.vocab_range) for p in decoded]
    for g, p in zip(modded, decoded):
        np.testing.assert_array_equal(g, jbase.positive_modulus(p["sparse"], jsch.vocab_range))
    per_thread = [tbase.generate_vocab_thread(m, tsch) for m in modded]
    want_per_thread = [jbase.generate_vocab_thread(m, jsch) for m in modded]
    assert [[s.order for s in t] for t in per_thread] == \
        [[s.order for s in t] for t in want_per_thread]
    vocab = tbase.merge_sub_dictionaries(per_thread, tsch)
    assert vocab == jbase.merge_sub_dictionaries(want_per_thread, jsch)
    applied = [tbase.apply_vocab(p, vocab, tsch) for p in decoded]
    for g, p in zip(applied, decoded):
        _equal_tables(g, jbase.apply_vocab(p, vocab, jsch))
    _equal_tables(tbase.concatenate(applied), jbase.concatenate(applied))
    _equal_tables(tbase.run_pipeline(buf, tsch, n_threads=n_threads),
                  jbase.run_pipeline(buf, jsch, n_threads=n_threads))


def test_empty_input_decodes_to_empty_tables():
    for buf in (np.zeros(0, np.uint8), np.zeros(64, np.uint8)):
        _equal_tables(tbase.decode_rows_serial(buf, tschema.CRITEO),
                      jbase.decode_rows_serial(buf, jschema.CRITEO))


@pytest.mark.parametrize("n_threads", [1, 2, 4])
@pytest.mark.parametrize("vocab_range", [5000, 1_000_000])
def test_binary_input_matches_reference(n_threads, vocab_range):
    """Config III: the pre-decoded table, row-partitioned directly."""
    table = jsynth.generate_binary(jsynth.SynthConfig(rows=333, seed=2))
    tsch = dataclasses.replace(tschema.CRITEO, vocab_range=vocab_range)
    jsch = dataclasses.replace(jschema.CRITEO, vocab_range=vocab_range)
    _equal_tables(tbase.run_pipeline(None, tsch, n_threads=n_threads, binary_input=table),
                  jbase.run_pipeline(None, jsch, n_threads=n_threads, binary_input=table))


def _valid_rows(outs) -> dict:
    outs = list(outs)
    return {k: np.concatenate([getattr(o, k)[o.valid].numpy() for o in outs]) for k in FIELDS}


def _assert_engine_equals_oracle(got, oracle):
    for k in ("label", "sparse"):
        np.testing.assert_array_equal(got[k], oracle[k], err_msg=k)
    np.testing.assert_allclose(got["dense"], oracle["dense"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("vocab_range", [5000, 1_000_000])
def test_quickstart_engine_equals_baseline_utf8(vocab_range):
    """The reference quickstart's check on the port: 2000 rows through the
    engine's two loops (64 KiB chunks) against the 4-thread baseline."""
    schema = dataclasses.replace(tschema.CRITEO, vocab_range=vocab_range)
    buf, _ = tsynth.make_dataset(tsynth.SynthConfig(schema=schema, rows=2000, seed=0))
    pipe = TP.PiperPipeline(TP.PipelineConfig(schema=schema, chunk_bytes=1 << 16,
                                              max_rows_per_chunk=1024, device="cpu"))
    vocab = pipe.build_vocab_stream(tsynth.chunk_stream(buf, 1 << 16))
    got = _valid_rows(pipe.transform_stream(vocab, tsynth.chunk_stream(buf, 1 << 16)))
    _assert_engine_equals_oracle(got, tbase.run_pipeline(buf, schema, n_threads=4))


def test_quickstart_engine_equals_baseline_binary():
    """The same rows' binary table through the engine (BinaryChunkFeed
    chunks of 512 rows) against the baseline's Config III path."""
    cfg = tsynth.SynthConfig(rows=2000, seed=0)
    table = tsynth.generate_binary(cfg)
    table = {k: table[k] for k in FIELDS}
    pipe = TP.PiperPipeline(TP.PipelineConfig(schema=cfg.schema, max_rows_per_chunk=512,
                                              input_format="binary", device="cpu"))
    flat = tloader.BinaryChunkFeed(table, 512).flat_chunks()
    chunks = [{k: v[i] for k, v in flat.items()} for i in range(len(flat["label"]))]
    vocab = pipe.build_vocab_stream(chunks)
    got = _valid_rows(pipe.transform_stream(vocab, chunks))
    _assert_engine_equals_oracle(
        got, tbase.run_pipeline(None, cfg.schema, n_threads=4, binary_input=table))
