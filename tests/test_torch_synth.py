"""The port's synthetic data (repro_torch.data) against the JAX package's:
identical tables, bytes and chunks for the same seed."""

import dataclasses

import numpy as np
import pytest

from repro.core import schema as jschema
from repro.data import loader as jloader
from repro.data import synth as jsynth
from repro_torch.core import schema as tschema
from repro_torch.data import loader as tloader
from repro_torch.data import synth as tsynth

CASES = [
    # (rows, seed, schema fields) — empty table, one row, the tests' size,
    # and a non-Criteo layout
    (0, 1, {}),
    (1, 2, {}),
    (400, 42, {}),
    (257, 7, {"n_dense": 2, "n_sparse": 3, "vocab_range": 97}),
]


def _configs(rows, seed, fields):
    js = dataclasses.replace(jschema.CRITEO, **fields)
    ts = dataclasses.replace(tschema.CRITEO, **fields)
    return (
        jsynth.SynthConfig(schema=js, rows=rows, seed=seed),
        tsynth.SynthConfig(schema=ts, rows=rows, seed=seed),
    )


@pytest.mark.parametrize("rows,seed,fields", CASES)
def test_tables_and_bytes_identical(rows, seed, fields):
    jc, tc = _configs(rows, seed, fields)
    jt, tt = jsynth.generate_binary(jc), tsynth.generate_binary(tc)
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)
    assert jsynth.encode_utf8(jt, jc) == tsynth.encode_utf8(tt, tc)
    jb, _ = jsynth.make_dataset(jc)
    tb, _ = tsynth.make_dataset(tc)
    np.testing.assert_array_equal(jb, tb)


def test_encode_extreme_values():
    """int32 extremes, a zero hash that is present (prints "0"), empty
    fields and all-ones hashes encode byte-identically."""
    n = 4
    table = {
        "label": np.array([0, 1, 1, 0], np.int32),
        "dense": np.tile(
            np.array([-(2**31), 2**31 - 1, 0, -1, 9, 10, -10, 99, 100, 1, 2, 3, 4], np.int32),
            (n, 1),
        ),
        "sparse": np.tile(np.array([0, -1, 1, 15, 16] + [2**31 - 1] * 21, np.int32), (n, 1)),
        "dense_empty": np.zeros((n, 13), bool),
        "sparse_empty": np.zeros((n, 26), bool),
    }
    table["dense_empty"][1, ::2] = True
    table["sparse_empty"][2, 1::3] = True
    assert jsynth.encode_utf8(table, jsynth.SynthConfig()) == tsynth.encode_utf8(
        table, tsynth.SynthConfig()
    )


@pytest.mark.parametrize("chunk_bytes", [2048, 4096, 32768])
def test_chunk_stream_and_spans_identical(criteo_small, chunk_bytes):
    buf = criteo_small[0]
    want = list(jsynth.chunk_stream(buf, chunk_bytes))
    got = list(tsynth.chunk_stream(buf, chunk_bytes))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tsynth.row_spans(buf), jsynth.row_spans(buf))


def test_chunk_stream_rejects_overlong_row(criteo_small):
    with pytest.raises(ValueError, match="row longer than chunk_bytes"):
        list(tsynth.chunk_stream(criteo_small[0], 64))


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_request_payloads_identical(criteo_small, fmt):
    buf, table, _ = criteo_small
    sizes = [7, 1, 30, 13, 349]
    want = list(jsynth.request_payloads(buf, table, sizes, fmt))
    got = list(tsynth.request_payloads(buf, table, sizes, fmt))
    for g, w in zip(got, want):
        if fmt == "utf8":
            np.testing.assert_array_equal(g, w)
        else:
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("rows_per_chunk,shards", [(64, 1), (100, 3)])
def test_binary_chunk_feed_identical(criteo_small, rows_per_chunk, shards):
    table = criteo_small[1]
    want = jloader.BinaryChunkFeed(table, rows_per_chunk, shards)
    got = tloader.BinaryChunkFeed(table, rows_per_chunk, shards)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    for a, b in ((got.flat_chunks(), want.flat_chunks()),
                 (got.shard_stacks()[0], want.shard_stacks()[0])):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
