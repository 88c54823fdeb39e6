"""The port's fused loop-① update (repro_torch.kernels.fused_vocab) against
the JAX package's Pallas kernels in interpret mode — the VMEM route and the
forced slab route, with and without the count plane — and against
``vocab.update``, threaded across chunks. On the CPU the wrapper takes the
kernel's plain version; the CUDA kernel is held to it in
tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import vocab as jvocab
from repro.kernels.fused_vocab import ops as jfv
from repro_torch.core import ops as tops
from repro_torch.core import vocab as tvocab
from repro_torch.kernels.fused_vocab import ops as tfv


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
    a = tfv.tally("cpu", 101)
    assert a.dtype == torch.int64 and a.shape == (1,) and int(a) == 0
    assert tfv.tally(torch.device("cpu"), 101) is a
    assert tfv.tally("cpu", 102) is not a
