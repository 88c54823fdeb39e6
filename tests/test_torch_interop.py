"""Carrying loop-① state and vocabularies between the two packages
(repro_torch.interop): a state half built by one package's loop ①,
continued in the other's, equals either package's full run."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import pipeline as JP
from repro.core import vocab as jvocab
from repro.data import synth as jsynth
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import vocab as tvocab

CHUNK_BYTES, MAX_ROWS = 16384, 128


def _pipes(counts):
    kw = dict(chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, track_vocab_counts=counts)
    return (JP.PiperPipeline(JP.PipelineConfig(use_fused_kernel=False, **kw)),
            TP.PiperPipeline(TP.PipelineConfig(device="cpu", **kw)))


def _jax_state(first_pos, rows_seen, counts):
    return jvocab.VocabState(
        first_pos=jnp.asarray(first_pos), rows_seen=jnp.asarray(rows_seen),
        counts=None if counts is None else jnp.asarray(counts))


def _jax_loop1(pipe, state, chunks):
    for c in chunks:
        state = pipe.vocab_step(state, jnp.asarray(c))
    return state


def _torch_loop1(pipe, state, chunks):
    for c in chunks:
        state = pipe.vocab_step(state, c)
    return state


@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
def test_loop1_continues_across_packages(criteo_small, counts):
    chunks = list(jsynth.chunk_stream(criteo_small[0], CHUNK_BYTES))
    half = len(chunks) // 2
    assert half >= 2
    jpipe, tpipe = _pipes(counts)
    j_full = _jax_loop1(jpipe, jpipe.init_state(), chunks)
    t_full = _torch_loop1(tpipe, tpipe.init_state(), chunks)
    want = (np.asarray(j_full.first_pos), np.asarray(j_full.rows_seen),
            None if j_full.counts is None else np.asarray(j_full.counts))

    # JAX first half → the port's second half
    j_half = _jax_loop1(jpipe, jpipe.init_state(), chunks[:half])
    t_state = interop.vocab_state_from_numpy(
        np.asarray(j_half.first_pos), np.asarray(j_half.rows_seen),
        None if j_half.counts is None else np.asarray(j_half.counts), device="cpu")
    j_then_t = interop.vocab_state_to_numpy(_torch_loop1(tpipe, t_state, chunks[half:]))

    # the port's first half → JAX's second half
    t_half = interop.vocab_state_to_numpy(_torch_loop1(tpipe, tpipe.init_state(), chunks[:half]))
    t_then_j = _jax_loop1(jpipe, _jax_state(*t_half), chunks[half:])

    for got in (interop.vocab_state_to_numpy(t_full), j_then_t,
                (np.asarray(t_then_j.first_pos), np.asarray(t_then_j.rows_seen),
                 None if t_then_j.counts is None else np.asarray(t_then_j.counts))):
        np.testing.assert_array_equal(got[0], want[0])
        assert int(got[1]) == int(want[1])
        if counts:
            np.testing.assert_array_equal(got[2], want[2])
        else:
            assert got[2] is None


def test_vocabulary_round_trip_serves_identically(criteo_small):
    """A vocabulary finalized by JAX serves the same loop-② output in the
    port as in JAX."""
    buf = criteo_small[0]
    jpipe, tpipe = _pipes(False)
    jv = jpipe.build_vocab_stream(jsynth.chunk_stream(buf, CHUNK_BYTES))
    tv = interop.vocabulary_from_numpy(np.asarray(jv.table), np.asarray(jv.sizes), device="cpu")
    table, sizes = interop.vocabulary_to_numpy(tv)
    np.testing.assert_array_equal(table, np.asarray(jv.table))
    np.testing.assert_array_equal(sizes, np.asarray(jv.sizes))
    chunk = next(jsynth.chunk_stream(buf, CHUNK_BYTES))
    got = tpipe.transform_chunk(tv, chunk)
    want = jpipe.transform_chunk(jv, jnp.asarray(chunk))
    np.testing.assert_array_equal(got.sparse.numpy(), np.asarray(want.sparse))


def test_from_numpy_checks():
    fp = np.full((2, 8), tvocab.NEVER, np.int32)
    with pytest.raises(TypeError, match="int32"):
        interop.vocab_state_from_numpy(fp.astype(np.int64), np.int32(0), device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        interop.vocab_state_from_numpy(fp, np.zeros(1, np.int32), device="cpu")
    with pytest.raises(ValueError, match="counts"):
        interop.vocab_state_from_numpy(fp, np.int32(0), np.zeros((2, 4), np.int32), device="cpu")
    state = interop.vocab_state_from_numpy(fp, np.int32(5), device="cpu")
    fp[0, 0] = 0  # the state holds its own copy
    assert int(state.first_pos[0, 0]) == tvocab.NEVER and int(state.rows_seen) == 5
