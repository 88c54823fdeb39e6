"""The port's bytes-in route (repro_torch.kernels.fused_decode_vocab and
fused_decode_xform, and PipelineConfig.use_fused_decode) against the JAX
package on the CPU: the Pallas kernels in interpret mode on small chunks,
and the reference compositions (``core.ops.fused_decode_*`` with
``use_kernel=False``). Integers are compared bit for bit, dense values at
rtol 1e-6, on every row, padding included. On the CPU the port's wrappers
take their plain versions; the CUDA kernels are held to them in
tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import dataclasses
import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import pipeline as JP
from repro.core import schema as jschema
from repro.core import vocab as jvocab
from repro.kernels.fused_decode_vocab import ops as jfdv
from repro.kernels.fused_decode_xform import ops as jfdx
from repro_torch.core import ops as tops
from repro_torch.core import pipeline as TP
from repro_torch.core import schema as tschema
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth as tsynth
from repro_torch.kernels.fused_decode_vocab import ops as tfdv
from repro_torch.kernels.fused_decode_xform import ops as tfdx
from tests.test_decode_fuzz import _hostile_chunk

NEVER = tvocab.NEVER
# The Pallas kernels' byte tile in these tests, and the one length every
# buffer is padded to, so that each interpret-mode kernel compiles once.
BLOCK, SIZE = 256, 4096
DECODE_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "decode_fused_small.npz")

# The hostile corpus of tests/test_decode_fuzz.py, one chunk per class.
HANDCRAFTED = {
    "padding_only": b"",
    "bare_newlines": b"\n\n\n",
    "all_delim": b"\t\t\t\t\t\n",
    "trunc_mid_field": b"1\t2\t3\tab\tcd\n9\t8\t7\tee",
    "trunc_no_delim": b"1\t2\t3\tab\tcd",
    "trunc_at_delim": b"1\t2\t3\tab\tcd\n9\t8\t7\t",
    "overlong_invalid_hex": b"1\t-2\t3\tdeadbeefdeadbeef\tgz!\n",
    "weird_minus_crlf": b"1\t2-3\t--4\tab\tcd\r\n",
    "tile_straddle": b"0\t" + b"9" * 300 + b"\t3\tab\tcd\n",
}
TRUNCATION_ROWS = b"1\t-7\t0\tdeadbeef\tcafe\n0\t12\t\tf00d\tbeef\n"


def _pad(raw) -> np.ndarray:
    raw = bytes(raw)
    assert len(raw) <= SIZE
    buf = np.zeros(SIZE, np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf


def _hostile(seed, n_dense, n_sparse, n_rows, truncate) -> np.ndarray:
    buf = _hostile_chunk(seed, n_dense, n_sparse, n_rows, truncate)
    return _pad(buf[: np.flatnonzero(buf)[-1] + 1] if buf.any() else b"")


def _history(n_cols, vocab_range, seed):
    """A loop-① state with some history: a few early first positions."""
    rng = np.random.default_rng(seed)
    fp = np.where(rng.random((n_cols, vocab_range)) < 0.3,
                  rng.integers(0, 40, (n_cols, vocab_range)), NEVER)
    return fp.astype(np.int32)


def _states(first_pos, rows_seen):
    j = jvocab.VocabState(first_pos=jnp.asarray(first_pos), rows_seen=jnp.int32(rows_seen))
    t = tvocab.VocabState(torch.from_numpy(first_pos.copy()),
                          torch.tensor(rows_seen, dtype=torch.int32))
    return j, t


def _assert_state(t, j, what=""):
    np.testing.assert_array_equal(t.first_pos.numpy(), np.asarray(j.first_pos), err_msg=what)
    assert int(t.rows_seen) == int(j.rows_seen), what
    if j.counts is not None:
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts), err_msg=what)


def _assert_features(got, want, what=""):
    """(label, dense, ids, valid) of the port against the reference's."""
    for name, g, w in zip(("label", "dense", "ids", "valid"), got, want):
        if name == "dense":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, err_msg=what)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what} {name}")


def _kw(n_dense, n_sparse, max_rows):
    return dict(n_fields=1 + n_dense + n_sparse, n_dense=n_dense, n_sparse=n_sparse,
                max_rows=max_rows)


def _check_vocab(buf, n_dense, n_sparse, max_rows, vocab_range, rows_seen, pallas):
    """Port loop ① (wrapper and dispatcher) against the reference
    composition and, with ``pallas``, the interpret-mode kernel."""
    kw = _kw(n_dense, n_sparse, max_rows)
    fp0 = _history(n_sparse, vocab_range, rows_seen)
    j, t = _states(fp0, rows_seen)
    want = jops.fused_decode_vocab_update(j, jnp.asarray(buf), use_kernel=False, **kw)
    got = tops.fused_decode_vocab_update(t, torch.from_numpy(buf), **kw)
    _assert_state(got, want, "wrapper vs reference composition")
    _, t = _states(fp0, rows_seen)
    plain = tops.fused_decode_vocab_update(t, torch.from_numpy(buf), use_kernel=False, **kw)
    _assert_state(plain, want, "plain vs reference composition")
    if pallas:
        j, _ = _states(fp0, rows_seen)
        kern = jfdv.fused_decode_update(j, jnp.asarray(buf), n_fields=kw["n_fields"],
                                        hex_start=1 + n_dense, max_rows=max_rows, block=BLOCK)
        _assert_state(got, kern, "wrapper vs Pallas kernel")


def _vocabulary(buf, n_dense, n_sparse, max_rows, vocab_range):
    """The same vocabulary for both packages, built from ``buf``."""
    st = jops.fused_decode_vocab_update(jvocab.VocabState.init(n_sparse, vocab_range),
                                        jnp.asarray(buf), use_kernel=False,
                                        **_kw(n_dense, n_sparse, max_rows))
    jv = jvocab.finalize(st)
    tv = tvocab.Vocabulary(torch.from_numpy(np.array(jv.table)),
                           torch.from_numpy(np.array(jv.sizes)))
    return jv, tv


def _check_xform(buf, n_dense, n_sparse, max_rows, vocab_range, pallas):
    kw = _kw(n_dense, n_sparse, max_rows)
    jv, tv = _vocabulary(buf, n_dense, n_sparse, max_rows, vocab_range)
    want = jops.fused_decode_transform(jv, jnp.asarray(buf), use_kernel=False, **kw)
    for use_kernel in (True, False):
        got = tops.fused_decode_transform(tv, torch.from_numpy(buf), use_kernel=use_kernel, **kw)
        _assert_features(got, want, f"use_kernel={use_kernel}")
    if pallas:
        kern = jfdx.fused_decode_transform(jv, jnp.asarray(buf), n_fields=kw["n_fields"],
                                           hex_start=1 + n_dense, max_rows=max_rows,
                                           block=BLOCK)
        _assert_features(tfdx.fused_decode_transform(
            tv, torch.from_numpy(buf), n_fields=kw["n_fields"], hex_start=1 + n_dense,
            max_rows=max_rows), kern, "wrapper vs Pallas kernel")


# --------------------------------------------------------------------- #
# the two kernel modules, on the hostile corpus
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("rows_seen", [0, 7])
@pytest.mark.parametrize("name", list(HANDCRAFTED))
def test_handcrafted(name, rows_seen):
    """One chunk per hostile class; short rows among them, whose missing
    fields the reference wrapper corrects for after its kernel."""
    buf = _pad(HANDCRAFTED[name])
    _check_vocab(buf, 2, 2, 8, 17, rows_seen, pallas=True)
    if rows_seen == 0:
        _check_xform(buf, 2, 2, 8, 17, pallas=True)


def test_truncation_sweep():
    """Every cut of a two-row chunk, the final newline included."""
    for cut in range(1, 20):
        buf = _pad(TRUNCATION_ROWS[:-cut])
        _check_vocab(buf, 2, 2, 8, 17, cut % 8, pallas=cut % 4 == 0)
        _check_xform(buf, 2, 2, 8, 17, pallas=cut % 4 == 1)


@pytest.mark.parametrize("seed", range(8))
def test_hostile_chunks(seed):
    """Seeded mixes of every hostile class at assorted row counts and
    truncations, fields longer than the Pallas tile among them."""
    rng = np.random.default_rng(seed)
    buf = _hostile(seed, 2, 3, int(rng.integers(1, 30)), int(rng.integers(0, 30)))
    _check_vocab(buf, 2, 3, 32, 53, seed * 7, pallas=seed % 4 == 0)
    _check_xform(buf, 2, 3, 32, 53, pallas=seed % 4 == 1)


@pytest.mark.parametrize("n_rows", [33, 40, 48])
def test_overflow_rows(n_rows):
    """More rows than max_rows: overflow rows are never scattered or
    stored, and rows_seen advances by max_rows."""
    buf = _hostile(n_rows, 2, 3, n_rows, 0)
    _check_vocab(buf, 2, 3, 32, 53, 7, pallas=n_rows == 40)
    _check_xform(buf, 2, 3, 32, 53, pallas=n_rows == 33)
    got = tfdv.fused_decode_update(tvocab.VocabState.init(3, 53, device="cpu"),
                                   torch.from_numpy(buf), n_fields=6, hex_start=3, max_rows=32)
    assert int(got.rows_seen) == 32


@pytest.mark.parametrize("n_dense,n_sparse", [(0, 3), (3, 0)], ids=["n_dense=0", "n_sparse=0"])
def test_degenerate_widths(n_dense, n_sparse):
    """No dense column, or no sparse column: the reference wrappers route
    these around their kernels; the port's results are the same."""
    for seed in range(3):
        buf = _hostile(seed, n_dense, n_sparse, 12, seed)
        _check_vocab(buf, n_dense, n_sparse, 16, 29, seed, pallas=n_sparse > 0)
        _check_xform(buf, n_dense, n_sparse, 16, 29, pallas=False)


def test_counts_state_takes_the_decoded_route():
    """A count-tracking state: the count plane advances as the reference's
    (which routes it around the bytes-in kernel) advances it."""
    buf = _hostile(3, 2, 3, 20, 0)
    kw = _kw(2, 3, 32)
    j = jvocab.VocabState.init(3, 41, track_counts=True)
    t = tvocab.VocabState.init(3, 41, track_counts=True, device="cpu")
    for _ in range(2):
        j = jfdv.fused_decode_update(j, jnp.asarray(buf), n_fields=6, hex_start=3, max_rows=32)
        t = tops.fused_decode_vocab_update(t, torch.from_numpy(buf), **kw)
        _assert_state(t, j)


# --------------------------------------------------------------------- #
# saturation at the int32 position ceiling
# --------------------------------------------------------------------- #


def test_saturation_at_ceiling(monkeypatch):
    """rows_seen three below NEVER and more kept rows than that: positions
    and rows_seen saturate at NEVER, as the reference's do under jit. The
    host-side guard raises first in eager use on both sides; lifted here,
    the port's plain arithmetic is what the kernel is held to on the card."""
    buf = _hostile(11, 2, 2, 10, 0)
    kw = _kw(2, 2, 8)
    fp0 = _history(2, 17, 1)
    j, t = _states(fp0, NEVER - 3)
    with pytest.raises(OverflowError, match="ceiling"):
        tfdv.fused_decode_update(t, torch.from_numpy(buf), n_fields=5, hex_start=3, max_rows=8)
    with pytest.raises(OverflowError, match="ceiling"):
        jfdv.fused_decode_update(j, jnp.asarray(buf), n_fields=5, hex_start=3, max_rows=8)
    oracle = jax.jit(functools.partial(jops.fused_decode_vocab_update, use_kernel=False, **kw))
    want = oracle(j, jnp.asarray(buf))
    kern = jax.jit(functools.partial(jfdv.fused_decode_update, n_fields=5, hex_start=3,
                                     max_rows=8, block=BLOCK))(j, jnp.asarray(buf))
    np.testing.assert_array_equal(np.asarray(kern.first_pos), np.asarray(want.first_pos))
    assert int(kern.rows_seen) == int(want.rows_seen) == NEVER
    monkeypatch.setattr(tvocab, "check_row_ceiling", lambda *a: None)
    got = tfdv.fused_decode_update(t, torch.from_numpy(buf), n_fields=5, hex_start=3,
                                   max_rows=8)
    _assert_state(got, want)
    assert int(got.rows_seen) == NEVER
    new = got.first_pos.numpy()[got.first_pos.numpy() != fp0]
    assert set(new.tolist()) <= {NEVER - 3, NEVER - 2, NEVER - 1} and new.size > 0


# --------------------------------------------------------------------- #
# the slice as a whole: the engine with use_fused_decode
# --------------------------------------------------------------------- #


def _hostile_stream():
    """The hostile chunk stream of tests/test_decode_fuzz.py's engine test:
    five chunks of 12 rows at 3 dense and 4 sparse columns, the last
    truncated, zero-padded to one length."""
    chunks = [_hostile_chunk(seed, 3, 4, 12, truncate=(11 if seed == 4 else 0))
              for seed in range(5)]
    width = max(len(c) for c in chunks)  # one shape for the jitted reference
    return [np.pad(c, (0, width - len(c))) for c in chunks]


def _engines(counts):
    kw = dict(max_rows_per_chunk=32, use_fused_decode=True, track_vocab_counts=counts)
    j = JP.PiperPipeline(JP.PipelineConfig(
        schema=jschema.TableSchema(n_dense=3, n_sparse=4, vocab_range=101),
        use_fused_kernel=True, use_fused_vocab=True, **kw))
    t = TP.PiperPipeline(TP.PipelineConfig(
        schema=tschema.TableSchema(n_dense=3, n_sparse=4, vocab_range=101), device="cpu", **kw))
    return j, t


def _assert_batches(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        _assert_features((t.label, t.dense, t.sparse, t.valid),
                         (j.label, j.dense, j.sparse, j.valid))


@pytest.mark.parametrize("counts", [False, True], ids=["bytes-in", "counts"])
def test_pipeline_matches_reference_on_hostile_stream(counts):
    """PiperPipeline(use_fused_decode=True) in both packages: the same loop-①
    state and the same features on every chunk. With the count plane,
    loop ① takes decode + the loop-① kernel in both."""
    chunks = _hostile_stream()
    jpipe, tpipe = _engines(counts)
    assert (tpipe._bytes_vocab, tpipe._bytes_xform) == (jpipe._bytes_vocab, jpipe._bytes_xform)
    assert tpipe._bytes_vocab == (not counts) and tpipe._bytes_xform
    jstate = jpipe.build_state_stream(iter(chunks))
    tstate = tpipe.build_state_stream(iter(chunks))
    _assert_state(tstate, jstate)
    jv, tv = jvocab.finalize(jstate), tvocab.finalize(tstate)
    np.testing.assert_array_equal(tv.table.numpy(), np.asarray(jv.table))
    np.testing.assert_array_equal(tv.sizes.numpy(), np.asarray(jv.sizes))
    stream = list(tpipe.transform_stream(tv, iter(chunks)))
    _assert_batches(stream, list(jpipe.transform_stream(jv, iter(chunks))))
    if not counts:
        scan = TP.flatten_processed(tpipe.run_scan(np.stack(chunks)))
        for f in ("label", "dense", "sparse", "valid"):
            assert torch.equal(getattr(scan, f), torch.cat([getattr(o, f) for o in stream])), f
        step = tpipe.frozen_transform(tv)
        _assert_batches([step(c) for c in chunks[:2]], stream[:2])


@pytest.mark.parametrize("fused_decode", [True, False], ids=["bytes", "decoded"])
def test_decode_golden_digest(fused_decode):
    """tests/goldens/decode_fused_small.npz, by digest, through the port's
    bytes-in route (and the decoded route as a control) on the CPU."""
    g = np.load(DECODE_GOLDEN)
    cb = int(g["chunk_bytes"])
    pipe = TP.PiperPipeline(TP.PipelineConfig(
        chunk_bytes=cb, max_rows_per_chunk=int(g["max_rows_per_chunk"]),
        use_fused_decode=fused_decode, device="cpu"))
    assert pipe._bytes_vocab == pipe._bytes_xform == fused_decode
    outs = list(pipe.run_stream(lambda: tsynth.chunk_stream(g["buf"], cb)))
    label = np.concatenate([o.label[o.valid].numpy() for o in outs])
    dense = np.concatenate([o.dense[o.valid].numpy() for o in outs])
    sparse = np.concatenate([o.sparse[o.valid].numpy() for o in outs])
    np.testing.assert_array_equal(label, g["label"])
    np.testing.assert_array_equal(sparse, g["sparse"])
    np.testing.assert_allclose(dense, g["dense"], rtol=1e-6)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(label, np.int32).tobytes())
    h.update(np.ascontiguousarray(sparse, np.int32).tobytes())
    assert h.hexdigest() == str(g["digest"])


@pytest.mark.parametrize(
    "fmt,hint,counts,n_dense,n_sparse,expect",
    [
        ("utf8", True, False, 13, 26, (True, True)),
        ("utf8", True, True, 13, 26, (False, True)),
        ("utf8", None, False, 13, 26, (False, False)),
        ("utf8", False, False, 13, 26, (False, False)),
        ("binary", True, False, 13, 26, (False, False)),
        ("utf8", True, False, 0, 26, (True, False)),
        ("utf8", True, False, 13, 0, (False, False)),
    ],
    ids=["on", "counts", "none-is-off", "off", "binary", "n_dense=0", "n_sparse=0"],
)
def test_routing(fmt, hint, counts, n_dense, n_sparse, expect):
    """Which loops take the bytes-in route: the reference's rules for its
    default plan, config for config."""
    kw = dict(input_format=fmt, use_fused_decode=hint, track_vocab_counts=counts)
    tcfg = TP.PipelineConfig(
        schema=tschema.TableSchema(n_dense=n_dense, n_sparse=n_sparse), device="cpu", **kw)
    jcfg = JP.PipelineConfig(
        schema=jschema.TableSchema(n_dense=n_dense, n_sparse=n_sparse), use_fused_kernel=False,
        use_fused_vocab=False, **kw)
    assert tcfg.fused_decode_enabled == jcfg.fused_decode_enabled == bool(hint)
    t, j = TP.PiperPipeline(tcfg), JP.PiperPipeline(jcfg)
    assert (t._bytes_vocab, t._bytes_xform) == (j._bytes_vocab, j._bytes_xform) == expect


def test_binary_feed_ignores_the_hint(criteo_small):
    _, table, _ = criteo_small
    chunks = [{k: table[k][i:i + 100] for k in ("label", "dense", "sparse")}
              for i in range(0, 400, 100)]
    cfg = TP.PipelineConfig(input_format="binary", device="cpu")
    a = list(TP.PiperPipeline(cfg).run_stream(lambda: iter(chunks)))
    b = list(TP.PiperPipeline(dataclasses.replace(cfg, use_fused_decode=True))
             .run_stream(lambda: iter(chunks)))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        for f in ("label", "dense", "sparse", "valid"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f
