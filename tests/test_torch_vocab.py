"""The port's vocabulary engine (repro_torch.core.vocab) against the JAX
package's on the same numpy inputs: every function bit for bit, the
uint32 saturation near the int32 position ceiling, and the errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import vocab as jvocab
from repro_torch.core import ops as tops
from repro_torch.core import vocab as tvocab
from repro_torch.kernels.fused_vocab import ref as fvref

NEVER = tvocab.NEVER


def _t(x):
    return torch.from_numpy(np.array(x))


def _state_pair(first_pos, rows_seen, counts=None):
    j = jvocab.VocabState(
        first_pos=jnp.asarray(first_pos),
        rows_seen=jnp.int32(rows_seen),
        counts=None if counts is None else jnp.asarray(counts),
    )
    t = tvocab.VocabState(
        first_pos=_t(first_pos),
        rows_seen=torch.tensor(rows_seen, dtype=torch.int32),
        counts=None if counts is None else _t(counts),
    )
    return j, t


def _assert_state_equal(t, j):
    np.testing.assert_array_equal(t.first_pos.numpy(), np.asarray(j.first_pos))
    assert int(t.rows_seen) == int(j.rows_seen)
    assert (t.counts is None) == (j.counts is None)
    if j.counts is not None:
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


def test_constants():
    assert tvocab.NEVER == int(jvocab.NEVER)
    assert tvocab.MAX_ROWS == jvocab.MAX_ROWS


@pytest.mark.parametrize("rows_seen", [0, 12345, NEVER - 3, NEVER])
def test_positions_and_advance(rows_seen):
    rng = np.random.default_rng(rows_seen % 97)
    valid = rng.random(8) < 0.7
    want = jvocab.positions(jnp.int32(rows_seen), 8, jnp.asarray(valid))
    got = tvocab.positions(torch.tensor(rows_seen, dtype=torch.int32), 8, _t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n_new in (0, 3, 8, NEVER):
        w = jvocab.advance_rows_seen(jnp.int32(rows_seen), jnp.int32(n_new))
        g = tvocab.advance_rows_seen(
            torch.tensor(rows_seen, dtype=torch.int32), torch.tensor(n_new, dtype=torch.int32)
        )
        assert int(g) == int(w)


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_update_matches_across_chunks(track_counts):
    """Three chunks with random valid masks, duplicate keys and the full
    int32 hash range: state, counts and rows_seen equal after each."""
    rng = np.random.default_rng(3)
    n_cols, vocab_range = 5, 97
    j = jvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts)
    t = tvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts, device="cpu")
    for rows in (40, 1, 64):
        sparse = rng.integers(-(2**31), 2**31 - 1, size=(rows, n_cols), dtype=np.int64)
        sparse = sparse.astype(np.int32)
        sparse[::3, 1] = sparse[0, 1]  # repeated keys inside the chunk
        valid = rng.random(rows) < 0.8
        j = jvocab.update(j, jops.positive_modulus(jnp.asarray(sparse), vocab_range),
                          jnp.asarray(valid))
        t = tvocab.update(t, tops.positive_modulus(_t(sparse), vocab_range), _t(valid))
        _assert_state_equal(t, j)


def test_update_does_not_modify_its_input():
    t = tvocab.VocabState.init(2, 16, track_counts=True, device="cpu")
    tvocab.update(t, torch.zeros((4, 2), dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    assert bool((t.first_pos == NEVER).all()) and int(t.counts.sum()) == 0


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_saturation_at_ceiling(track_counts):
    """rows_seen three below the ceiling + 8 valid rows (the reference's
    tests/test_vocab_slab.py case, under jit there): exactly the three
    representable positions are written, nothing wraps negative, rows_seen
    saturates at NEVER and saturated rows drop from the counts. The port's
    arithmetic is the kernel's plain version (the CPU wrapper's host-side
    guard raises first, see test_ceiling_raises_eagerly)."""
    rows, n_cols, vocab_range = 8, 2, 64
    vals = np.arange(rows * n_cols, dtype=np.int32).reshape(rows, n_cols)
    valid = np.ones(rows, bool)
    counts0 = np.zeros((n_cols, vocab_range), np.int32) if track_counts else None
    j, t = _state_pair(np.full((n_cols, vocab_range), NEVER, np.int32), NEVER - 3, counts0)

    want = jax.jit(lambda s: jvocab.update(s, jnp.asarray(vals), jnp.asarray(valid)))(j)
    seen = fvref.fused_genvocab(t.first_pos, t.counts, _t(vals), _t(valid), t.rows_seen)
    got = tvocab.VocabState(t.first_pos, seen, t.counts)
    _assert_state_equal(got, want)
    fp = got.first_pos.numpy()
    assert (fp >= 0).all()
    assert set(fp[fp < NEVER].tolist()) == {NEVER - 3, NEVER - 2, NEVER - 1}
    assert int(got.rows_seen) == NEVER
    if track_counts:
        assert int(got.counts.sum()) == 3 * n_cols


def test_ceiling_raises_eagerly():
    """Host-resident rows_seen: update and the fused wrapper raise instead
    of saturating silently, as the reference's eager entry points do."""
    state = tvocab.VocabState(
        first_pos=torch.full((1, 64), NEVER, dtype=torch.int32),
        rows_seen=torch.tensor(NEVER - 3, dtype=torch.int32),
    )
    vals = torch.zeros((8, 1), dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(OverflowError, match="ceiling"):
        tvocab.update(state, vals, valid)
    with pytest.raises(OverflowError, match="ceiling"):
        tops.fused_vocab_update(state, vals, valid, use_kernel=True)
    tvocab.check_row_ceiling(NEVER - 8, 8)  # exactly at the ceiling is fine


def _random_states(rng, n, n_cols, vocab_range, track_counts):
    fps = np.where(
        rng.random((n, n_cols, vocab_range)) < 0.4,
        rng.integers(0, 10_000, size=(n, n_cols, vocab_range)),
        NEVER,
    ).astype(np.int32)
    seen = rng.integers(0, 2**30, size=n).astype(np.int32)
    counts = rng.integers(0, 50, size=(n, n_cols, vocab_range)).astype(np.int32) \
        if track_counts else None
    return fps, seen, counts


@pytest.mark.parametrize("n_shards", [1, 3, 4, 5])
@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_merge_and_merge_tree(n_shards, track_counts):
    rng = np.random.default_rng(n_shards)
    fps, seen, counts = _random_states(rng, n_shards, 3, 33, track_counts)
    seen[0] = NEVER - 1  # the saturating add of rows_seen
    j, t = _state_pair(fps, 0, counts)
    j = jvocab.VocabState(j.first_pos, jnp.asarray(seen), j.counts)
    t = tvocab.VocabState(t.first_pos, _t(seen), t.counts)
    _assert_state_equal(tvocab.merge_tree(t), jvocab.merge_tree(j))
    pick = lambda s, i: type(s)(  # noqa: E731
        s.first_pos[i], s.rows_seen[i], None if s.counts is None else s.counts[i]
    )
    _assert_state_equal(tvocab.merge(pick(t, 0), pick(t, -1)),
                        jvocab.merge(pick(j, 0), pick(j, -1)))


@pytest.mark.parametrize(
    "a_kw,b_kw",
    [
        ({}, {"vocab_range": 32}),
        ({}, {"track_counts": True}),
        ({"track_counts": True}, {}),
    ],
    ids=["layout", "counts-vs-plain", "plain-vs-counts"],
)
def test_check_compatible_errors(a_kw, b_kw):
    def make(mod, kw, **extra):
        kw = {"vocab_range": 16, "track_counts": False, **kw}
        return mod.VocabState.init(2, kw["vocab_range"], track_counts=kw["track_counts"], **extra)

    with pytest.raises(ValueError) as want:
        jvocab.merge(make(jvocab, a_kw), make(jvocab, b_kw))
    with pytest.raises(ValueError) as got:
        tvocab.merge(make(tvocab, a_kw, device="cpu"), make(tvocab, b_kw, device="cpu"))
    assert str(got.value) == str(want.value)


def test_check_compatible_dtype_error():
    a = tvocab.VocabState.init(2, 16, device="cpu")
    b = tvocab.VocabState(a.first_pos.to(torch.int64), a.rows_seen)
    with pytest.raises(ValueError, match="different first_pos dtypes"):
        tvocab.check_compatible(a, b)


def test_finalizers_and_lookup():
    rng = np.random.default_rng(11)
    n_cols, vocab_range = 4, 50
    fps = np.where(
        rng.random((n_cols, vocab_range)) < 0.5,
        rng.permutation(n_cols * vocab_range).reshape(n_cols, vocab_range),
        NEVER,
    ).astype(np.int32)
    counts = np.where(fps < NEVER, rng.integers(1, 6, size=fps.shape), 0).astype(np.int32)
    j, t = _state_pair(fps, 200, counts)

    def same(got, want):
        np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
        np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
        assert got.table.dtype == got.sizes.dtype == torch.int32

    same(tvocab.finalize(t), jvocab.finalize(j))
    for k in (0, 1, 7, 25, 1000):
        same(tvocab.finalize_topk(t, k), jvocab.finalize_topk(j, k))
    for m in (1, 2, 4, 99):
        same(tvocab.finalize_min_count(t, m), jvocab.finalize_min_count(j, m))

    modded = rng.integers(0, vocab_range, size=(30, n_cols)).astype(np.int32)
    tv, jv = tvocab.finalize(t), jvocab.finalize(j)
    np.testing.assert_array_equal(
        tvocab.lookup(tv, _t(modded)).numpy(), np.asarray(jvocab.lookup(jv, jnp.asarray(modded)))
    )
    assert tv.vocab_range == vocab_range
    assert torch.equal(tv.oov_ordinals, tv.sizes)


def test_finalizer_errors():
    plain = tvocab.VocabState.init(2, 8, device="cpu")
    with pytest.raises(ValueError, match="count-tracking"):
        tvocab.finalize_topk(plain, 3)
    with pytest.raises(ValueError, match="count-tracking"):
        tvocab.finalize_min_count(plain, 1)
    tracked = tvocab.VocabState.init(2, 8, track_counts=True, device="cpu")
    with pytest.raises(ValueError, match="k >= 0"):
        tvocab.finalize_topk(tracked, -1)
    with pytest.raises(ValueError, match="min_count >= 1"):
        tvocab.finalize_min_count(tracked, 0)
