"""The port's per-op kernels' plain versions and wrappers
(repro_torch.kernels.vocab, repro_torch.kernels.dense_xform) against the
JAX package's refs and its Pallas kernels in interpret mode, on the same
numpy inputs: GenVocab with and without the count plane (duplicate keys
within a chunk, invalid rows, ``rows_seen`` at 0 and at ``NEVER - 3``,
where positions saturate), ApplyVocab, and the dense transform on int32
extremes and f32 input. On the CPU each wrapper takes its plain version;
the CUDA kernels are held to them in tests/test_torch_cuda.py and on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import vocab as jvocab
from repro.kernels.dense_xform import kernel as jdx_kernel
from repro.kernels.dense_xform import ref as jdx_ref
from repro.kernels.vocab import kernel as jv_kernel
from repro.kernels.vocab import ops as jv_ops
from repro.kernels.vocab import ref as jv_ref
from repro_torch.core import ops as tops
from repro_torch.core import vocab as tvocab
from repro_torch.kernels.dense_xform import ops as tdx_ops
from repro_torch.kernels.dense_xform import ref as tdx_ref
from repro_torch.kernels.vocab import ops as tv_ops
from repro_torch.kernels.vocab import ref as tv_ref

N_COLS, ROWS, V = 6, 256, 101


def _modded(seed, rows=ROWS, n_cols=N_COLS, vocab_range=V):
    rng = np.random.default_rng(seed)
    modded = rng.integers(0, vocab_range, size=(rows, n_cols)).astype(np.int32)
    if rows:
        modded[1::5] = modded[0]  # equal keys within the chunk min-combine
    return modded, rng.random(rows) < 0.8


def _positions(seed, rows_seen):
    _, valid = _modded(seed)
    return np.array(jvocab.positions(jnp.int32(rows_seen), ROWS, jnp.asarray(valid)))


@pytest.mark.parametrize("rows_seen", [0, 7, tvocab.NEVER - 3], ids=["start", "offset", "ceiling"])
def test_genvocab_ref_matches_reference(rows_seen):
    modded, _ = _modded(1)
    pos = _positions(1, rows_seen)
    rng = np.random.default_rng(2)
    state = np.where(rng.random((N_COLS, V)) < 0.3, rng.integers(0, 50, (N_COLS, V)),
                     tvocab.NEVER).astype(np.int32)
    vals_t = np.ascontiguousarray(modded.T)
    want_ref = np.asarray(jv_ref.genvocab(jnp.asarray(state), jnp.asarray(vals_t),
                                          jnp.asarray(pos)))
    want_kernel = np.asarray(jv_kernel.genvocab(jnp.asarray(state), jnp.asarray(vals_t),
                                                jnp.asarray(pos)))
    np.testing.assert_array_equal(want_kernel, want_ref)
    st = torch.from_numpy(state)
    got = tv_ref.genvocab(st, torch.from_numpy(vals_t), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(st.numpy(), state)  # the plain version is functional


def test_apply_vocab_ref_matches_reference():
    modded, _ = _modded(3)
    rng = np.random.default_rng(4)
    table = rng.integers(0, 1000, size=(N_COLS, V)).astype(np.int32)
    vals_t = np.ascontiguousarray(modded.T)
    want = np.asarray(jv_ref.apply_vocab(jnp.asarray(table), jnp.asarray(vals_t)))
    np.testing.assert_array_equal(
        np.asarray(jv_kernel.apply_vocab(jnp.asarray(table), jnp.asarray(vals_t),
                                         row_block=128)), want)
    got = tv_ref.apply_vocab(torch.from_numpy(table), torch.from_numpy(vals_t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the pipeline's row-major layout
    ids = tv_ops.apply_vocab(torch.from_numpy(table), torch.from_numpy(modded))
    np.testing.assert_array_equal(ids.numpy(), want.T)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jv_ops.apply_vocab_vmem(jnp.asarray(table), jnp.asarray(modded))))


def _states(track_counts, rows_seen):
    j = jvocab.VocabState.init(N_COLS, V, track_counts=track_counts)
    j = jvocab.VocabState(j.first_pos, jnp.int32(rows_seen), j.counts)
    t = tvocab.VocabState.init(N_COLS, V, track_counts=track_counts, device="cpu")
    t.rows_seen.fill_(rows_seen)
    return j, t


@pytest.mark.parametrize("rows_seen", [0, 7], ids=["start", "offset"])
@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_genvocab_update_matches_pallas_route(track_counts, rows_seen):
    """The wrapper threaded over chunks against the reference's
    genvocab_update (the Pallas kernel in interpret mode)."""
    j, t = _states(track_counts, rows_seen)
    for seed in (5, 6):
        modded, valid = _modded(seed)
        j = jv_ops.genvocab_update(j, jnp.asarray(modded), jnp.asarray(valid))
        t = tv_ops.genvocab_update(t, torch.from_numpy(modded), torch.from_numpy(valid))
        np.testing.assert_array_equal(t.first_pos.numpy(), np.asarray(j.first_pos))
        assert int(t.rows_seen) == int(j.rows_seen)
        if track_counts:
            np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


def test_saturation_at_the_ceiling():
    """rows_seen = NEVER - 3: both wrappers' host-side guards refuse the
    chunk; the plain versions, fed the saturated positions, keep the valid
    rows among the first three in state and counts and drop the rest, as
    the reference's scatter-min and count increment do."""
    modded, valid = _modded(14)
    j, t = _states(True, tvocab.NEVER - 3)
    with pytest.raises(OverflowError):
        jv_ops.genvocab_update(j, jnp.asarray(modded), jnp.asarray(valid))
    with pytest.raises(OverflowError):
        tv_ops.genvocab_update(t, torch.from_numpy(modded), torch.from_numpy(valid))
    pos = _positions(14, tvocab.NEVER - 3)
    live = np.flatnonzero(pos < tvocab.NEVER)
    assert 0 < len(live) <= 3 and live.max() < 3
    vals_t = np.ascontiguousarray(modded.T)
    got = tv_ref.genvocab_counts(t.counts, torch.from_numpy(vals_t), torch.from_numpy(pos))
    # the reference's count increment (kernels/vocab/ops.py), in numpy
    want = np.zeros((N_COLS, V), np.int32)
    for r in live:
        want[np.arange(N_COLS), modded[r]] += 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == len(live) * N_COLS


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_genvocab_update_matches_vocab_update(track_counts):
    """Against vocab.update on the same modded chunks, with empty chunks."""
    _, t = _states(track_counts, 0)
    u = tvocab.VocabState.init(N_COLS, V, track_counts=track_counts, device="cpu")
    for seed, rows in ((7, ROWS), (8, 0), (9, 33)):
        modded, valid = _modded(seed, rows=rows)
        m, v = torch.from_numpy(modded), torch.from_numpy(valid)
        t, u = tv_ops.genvocab_update(t, m, v), tvocab.update(u, m, v)
        assert torch.equal(t.first_pos, u.first_pos) and torch.equal(t.rows_seen, u.rows_seen)
        if track_counts:
            assert torch.equal(t.counts, u.counts)


def test_vocab_wrappers_reject_column_mismatch():
    state = tvocab.VocabState.init(3, 16, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        tv_ops.genvocab_update(state, torch.zeros((4, 2), dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="columns"):
        tv_ops.apply_vocab(torch.zeros((3, 16), dtype=torch.int32),
                           torch.zeros((4, 2), dtype=torch.int32))


_EXTREMES = np.array([-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1], np.int32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_dense_transform_matches_reference(dtype):
    rng = np.random.default_rng(11)
    if dtype == "int32":
        x = rng.integers(-(2**31), 2**31 - 1, size=(128, 13), dtype=np.int64).astype(np.int32)
        x[0, : len(_EXTREMES)] = _EXTREMES
    else:
        x = (rng.standard_normal((128, 13)) * 1e3).astype(np.float32)
        x[0, :6] = [-np.inf, -0.0, 0.0, 1e-30, 3.4e38, np.inf]
    want = np.asarray(jdx_ref.dense_transform(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(jdx_kernel.dense_transform(jnp.asarray(x))), want,
                               rtol=1e-6)
    for got in (tdx_ref.dense_transform(torch.from_numpy(x)),
                tdx_ops.dense_transform(torch.from_numpy(x)),
                tops.dense_transform(torch.from_numpy(x), use_kernel=True),
                tops.dense_transform(torch.from_numpy(x))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        tops.dense_transform(torch.from_numpy(x), use_kernel=True).numpy(),
        np.asarray(jops.dense_transform(jnp.asarray(x), use_kernel=True)), rtol=1e-6)


def test_apply_vocab_dispatcher_matches_reference():
    """core.ops.apply_vocab with and without the kernel, against the
    reference's dispatcher with its kernel (interpret mode)."""
    modded, _ = _modded(12)
    rng = np.random.default_rng(13)
    table = rng.integers(0, 1000, size=(N_COLS, V)).astype(np.int32)
    jv = jvocab.Vocabulary(table=jnp.asarray(table), sizes=jnp.zeros(N_COLS, jnp.int32))
    tv = tvocab.Vocabulary(table=torch.from_numpy(table), sizes=torch.zeros(N_COLS, dtype=torch.int32))
    want = np.asarray(jops.apply_vocab(jv, jnp.asarray(modded), use_kernel=True))
    for use_kernel in (False, True):
        got = tops.apply_vocab(tv, torch.from_numpy(modded), use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
