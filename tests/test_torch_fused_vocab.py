"""The port's fused loop-① update (repro_torch.kernels.fused_vocab) against
the JAX package's Pallas kernels in interpret mode — the VMEM route and the
forced slab route, with and without the count plane — and against
``vocab.update``, threaded across chunks. On the CPU the wrapper takes the
kernel's plain version; the CUDA kernel is held to it in
tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import vocab as jvocab
from repro.kernels.fused_vocab import ops as jfv
from repro_torch.core import ops as tops
from repro_torch.core import vocab as tvocab
from repro_torch.kernels import _scratch
from repro_torch.kernels.fused_vocab import ops as tfv
from repro_torch.kernels.fused_vocab import ref as tfv_ref


def _chunks(seed, n_cols, sizes):
    rng = np.random.default_rng(seed)
    for rows in sizes:
        sparse = rng.integers(-(2**31), 2**31 - 1, size=(rows, n_cols), dtype=np.int64)
        sparse = sparse.astype(np.int32)
        sparse[1::4] = sparse[:1]  # repeated rows: equal keys min-combine
        yield sparse, rng.random(rows) < 0.75


def _same(t, j):
    np.testing.assert_array_equal(t.first_pos.numpy(), np.asarray(j.first_pos))
    assert int(t.rows_seen) == int(j.rows_seen)
    if j.counts is not None:
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


@pytest.mark.parametrize(
    "vocab_range,slab_range,track_counts",
    [(257, None, False), (257, None, True), (300, 128, False), (300, 128, True)],
    ids=["vmem", "vmem-counts", "slab", "slab-counts"],
)
def test_matches_pallas_routes(vocab_range, slab_range, track_counts):
    n_cols = 3
    j = jvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts)
    t = tvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts, device="cpu")
    for sparse, valid in _chunks(vocab_range, n_cols, (37, 8)):
        j = jfv.fused_update(j, jnp.asarray(sparse), jnp.asarray(valid), slab_range=slab_range)
        t = tfv.fused_update(t, torch.from_numpy(sparse), torch.from_numpy(valid))
        _same(t, j)


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_matches_update_across_chunks(track_counts):
    n_cols, vocab_range = 4, 1000
    j = jvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts)
    t = tvocab.VocabState.init(n_cols, vocab_range, track_counts=track_counts, device="cpu")
    for sparse, valid in _chunks(9, n_cols, (64, 1, 100, 0)):
        j = jvocab.update(j, jops.positive_modulus(jnp.asarray(sparse), vocab_range),
                          jnp.asarray(valid))
        t = tops.fused_vocab_update(t, torch.from_numpy(sparse), torch.from_numpy(valid))
        _same(t, j)


def test_updates_state_in_place():
    t = tvocab.VocabState.init(2, 16, track_counts=True, device="cpu")
    fp, counts = t.first_pos, t.counts
    out = tfv.fused_update(t, torch.zeros((4, 2), dtype=torch.int32),
                           torch.ones(4, dtype=torch.bool))
    assert out.first_pos is fp and out.counts is counts
    assert int(fp[0, 0]) == 0 and int(counts[0, 0]) == 4 and int(out.rows_seen) == 4


def test_rejects_column_mismatch():
    t = tvocab.VocabState.init(3, 16, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        tfv.fused_update(t, torch.zeros((4, 2), dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool))


def test_tally_is_kept_per_device_and_stream():
    """The kernel's row tally: int64 [1], zero when made, one per (device,
    stream), the same tensor on every later call for that pair."""
    a = _scratch.tally("cpu", 101)
    assert a.dtype == torch.int64 and a.shape == (1,) and int(a) == 0
    assert _scratch.tally(torch.device("cpu"), 101) is a
    assert _scratch.tally("cpu", 102) is not a


@pytest.mark.parametrize(
    "n_cols,rows_seen",
    [(6, tvocab.NEVER - 3), (40, 7), (40, tvocab.NEVER - 3)],
    ids=["ceiling", "40_columns", "40_columns_at_ceiling"],
)
def test_counts_route_edges_match_pallas_slab_route(n_cols, rows_seen):
    """The count plane where the card kernel splits its work: 40 columns
    (more than its 32 warps a block) and ``rows_seen`` at NEVER - 3, where
    positions saturate and the counts stop with them. Against the JAX slab
    route (``slab_range`` forced, counts tracked; traced, so its host-side
    ceiling guard stands aside as in a jitted engine) and ``vocab.update``.
    At the ceiling both wrappers' host-side guards refuse the chunk, so the
    port is held through its plain version, which its wrapper runs on the
    CPU."""
    vocab_range = 300
    (sparse, valid), = _chunks(n_cols + rows_seen % 1000, n_cols, (37,))
    valid[::3] = True
    valid[1::7] = False  # scattered valid rows: no prefix
    rng = np.random.default_rng(n_cols)
    first = rng.integers(0, 50, (n_cols, vocab_range)).astype(np.int32)
    first[rng.random(first.shape) < 0.5] = tvocab.NEVER
    counts = rng.integers(0, 9, (n_cols, vocab_range)).astype(np.int32)

    def jstate():
        return jvocab.VocabState(jnp.asarray(first), jnp.int32(rows_seen), jnp.asarray(counts))

    slab = jax.jit(functools.partial(jfv.fused_update, slab_range=128))
    j = slab(jstate(), jnp.asarray(sparse), jnp.asarray(valid))
    u = jax.jit(jvocab.update)(jstate(), jops.positive_modulus(jnp.asarray(sparse), vocab_range),
                               jnp.asarray(valid))
    for f in ("first_pos", "rows_seen", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), np.asarray(getattr(u, f)))
    t = tvocab.VocabState(torch.from_numpy(first.copy()),
                          torch.tensor(rows_seen, dtype=torch.int32),
                          torch.from_numpy(counts.copy()))
    if rows_seen == tvocab.NEVER - 3:
        with pytest.raises(OverflowError):
            tfv.fused_update(t, torch.from_numpy(sparse), torch.from_numpy(valid))
        t.rows_seen = tfv_ref.fused_genvocab(t.first_pos, t.counts, torch.from_numpy(sparse),
                                             torch.from_numpy(valid), t.rows_seen)
        # the first three rows alone have positions; the valid ones among them count
        live = int(valid[:3].sum())
        assert int((t.counts - torch.from_numpy(counts)).sum()) == live * n_cols
        assert int(t.rows_seen) == tvocab.NEVER
    else:
        t = tfv.fused_update(t, torch.from_numpy(sparse), torch.from_numpy(valid))
    _same(t, j)
