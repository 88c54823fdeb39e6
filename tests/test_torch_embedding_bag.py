"""The port's embedding gather (repro_torch.kernels.embedding_bag) against
the JAX package on the same numpy inputs: its ref and its Pallas kernel in
interpret mode for the forward pass, ``jax.grad`` through the ref for the
gradient, in-range and out-of-range ids. On the CPU the autograd Function
takes its plain versions; the CUDA kernels are held to them in
tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag import ref as jref
from repro_torch.kernels.embedding_bag import ops as tops
from repro_torch.kernels.embedding_bag import ref as tref

# (n_cols, vocab, dim, batch): Criteo's 26 columns at a narrow width; a dim
# that is not a multiple of 4; a batch that is not a multiple of 512.
SHAPES = [(26, 257, 16, 64), (3, 11, 5, 40), (4, 97, 8, 600)]


def _inputs(seed, n_cols, vocab, dim, batch, hot=True):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((n_cols, vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, (batch, n_cols)).astype(np.int32)
    if hot:  # repeated ids, so the gradient sums several rows into one
        ids[::3] = rng.integers(0, min(vocab, 4), (len(ids[::3]), n_cols))
    grad_out = rng.standard_normal((batch, n_cols, dim)).astype(np.float32)
    return tables, ids, grad_out


def _out_of_range(ids, vocab):
    ids = ids.copy()
    ids[0, :3] = [-1, vocab, vocab + 7]
    ids[1, :3] = [-vocab - 3, 2 * vocab, -2]
    return ids


def _jax_grad(tables, ids, grad_out):
    def f(t):
        return jnp.sum(jnp.asarray(grad_out) * jref.embedding_gather(t, jnp.asarray(ids)))

    return np.asarray(jax.grad(f)(jnp.asarray(tables)))


def _sum_bound(grad_out, ids, vocab):
    """Per element, the error bound of two float32 sums of the same n terms
    in different orders: 2·(n-1)·2^-24·Σ|terms|, n the largest number of
    rows that add into one gradient row."""
    t = torch.from_numpy(ids)
    n = max(int(torch.unique(tref.wrap_ids(t[:, c], vocab), return_counts=True)[1].max())
            for c in range(ids.shape[1]))
    abs_sum = tref.embedding_gather_backward(
        torch.from_numpy(np.abs(grad_out)), t, vocab, dtype=torch.float64).numpy()
    return 2 * max(n - 1, 1) * 2.0**-24 * abs_sum


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_ref_and_pallas_kernel(shape):
    """In-range ids: the port's forward, plain and through the autograd
    Function, equals the ref and the Pallas kernel bit for bit (a gather
    does no arithmetic)."""
    tables, ids, _ = _inputs(1, *shape)
    want = np.asarray(jref.embedding_gather(jnp.asarray(tables), jnp.asarray(ids)))
    want_kernel = np.asarray(
        jops.embedding_gather(jnp.asarray(tables), jnp.asarray(ids), use_kernel=True))
    np.testing.assert_array_equal(want_kernel, want)
    t, i = torch.from_numpy(tables), torch.from_numpy(ids)
    np.testing.assert_array_equal(tref.embedding_gather(t, i).numpy(), want)
    np.testing.assert_array_equal(tops.embedding_gather(t, i).numpy(), want)


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradient_matches_jax_grad(shape, out_of_range):
    """The plain gradient and the autograd Function's against ``jax.grad``
    of ``sum(w · ref.embedding_gather)``. Tolerance: two float32 sums of the
    same terms in another order (``_sum_bound``); XLA's scatter-add on the
    CPU gave the same bits here."""
    tables, ids, grad_out = _inputs(2, *shape)
    vocab = shape[1]
    if out_of_range:
        ids = _out_of_range(ids, vocab)
    want = _jax_grad(tables, ids, grad_out)
    bound = _sum_bound(grad_out, ids, vocab)
    got = tref.embedding_gather_backward(torch.from_numpy(grad_out), torch.from_numpy(ids),
                                         vocab).numpy()
    assert (np.abs(got - want) <= bound).all()
    t = torch.from_numpy(tables).requires_grad_()
    tops.embedding_gather(t, torch.from_numpy(ids)).backward(torch.from_numpy(grad_out))
    np.testing.assert_array_equal(t.grad.numpy(), got)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_out_of_range_ids_forward_follows_ref(shape):
    """Ids -1, V, V+7, -V-3, 2V and -2 against the ref: a negative id wraps
    once, then the row is clamped into [0, V-1]."""
    tables, ids, _ = _inputs(3, *shape)
    vocab = shape[1]
    ids = _out_of_range(ids, vocab)
    want = np.asarray(jref.embedding_gather(jnp.asarray(tables), jnp.asarray(ids)))
    got = tops.embedding_gather(torch.from_numpy(tables), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], tables[0, vocab - 1])  # -1 wraps
    np.testing.assert_array_equal(got[0, 1], tables[1, vocab - 1])  # V clamps
    np.testing.assert_array_equal(got[1, 0], tables[0, 0])  # -V-3 wraps to -3, clamps


def test_out_of_range_ids_gradient_is_dropped_like_ref():
    """The reference's gradient (XLA's scatter-add transpose of its gather)
    drops an id still outside [0, V) after the wrap, though the forward read
    a clamped row for it; -1 wraps and adds into row V-1. The port pins
    that."""
    n_cols, vocab, dim = 3, 11, 2
    tables = np.zeros((n_cols, vocab, dim), np.float32)
    ids = np.array([[-1, vocab, vocab + 7], [-vocab - 3, 2 * vocab, -2]], np.int32)
    grad_out = np.ones((2, n_cols, dim), np.float32)
    want = _jax_grad(tables, ids, grad_out)
    got = tref.embedding_gather_backward(torch.from_numpy(grad_out), torch.from_numpy(ids),
                                         vocab).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, vocab - 1, 0] == 1 and want[2, vocab - 2, 0] == 1
    assert want[1].sum() == 0  # ids V and 2V: dropped
    assert want[0, 0].sum() == 0 and want[2, vocab - 1].sum() == 0  # -V-3, V+7


def test_pallas_kernel_fills_nan_for_ids_past_the_table():
    """Records the reference's own disagreement, which the port does not
    follow: its Pallas kernel (``use_kernel=True``) wraps -1 like the ref
    but fills NaN for ids >= V, where the ref clamps."""
    n_cols, vocab, dim = 3, 11, 4
    tables, _, _ = _inputs(4, n_cols, vocab, dim, 8)
    ids = np.array([[-1, vocab, vocab + 7], [0, 1, 2]], np.int32)
    got = np.asarray(jops.embedding_gather(jnp.asarray(tables), jnp.asarray(ids),
                                           use_kernel=True))
    np.testing.assert_array_equal(got[0, 0], tables[0, vocab - 1])
    assert np.isnan(got[0, 1]).all() and np.isnan(got[0, 2]).all()
    np.testing.assert_array_equal(got[1], tables[[0, 1, 2], [0, 1, 2]])


def test_plain_gradient_sums_in_ascending_batch_order():
    """The plain float32 gradient is each row's sum in ascending b, bit for
    bit against an explicit loop (what the card's kernel also computes for
    a run inside one 32-row tile)."""
    tables, ids, grad_out = _inputs(5, 4, 7, 6, 300)
    got = tref.embedding_gather_backward(torch.from_numpy(grad_out), torch.from_numpy(ids),
                                         7).numpy()
    loop = np.zeros_like(tables)
    for c in range(4):
        for b in range(300):
            loop[c, ids[b, c]] += grad_out[b, c]
    np.testing.assert_array_equal(got, loop)


def test_float64_gradient_and_no_launch_on_the_cpu():
    """The float64 variant (the card's reference) agrees with the float32
    sum within ``_sum_bound``; CPU tensors never touch the launch counters."""
    tables, ids, grad_out = _inputs(6, 26, 257, 16, 64)
    before = (tops.KERNEL.launches, tops.KERNEL_BACKWARD.launches)
    g, i = torch.from_numpy(grad_out), torch.from_numpy(ids)
    g64 = tref.embedding_gather_backward(g, i, 257, dtype=torch.float64)
    assert g64.dtype == torch.float64
    g32 = tops.embedding_gather_backward(g, i, 257)
    assert (np.abs(g32.numpy() - g64.numpy()) <= _sum_bound(grad_out, ids, 257)).all()
    tops.embedding_gather(torch.from_numpy(tables), i)
    assert (tops.KERNEL.launches, tops.KERNEL_BACKWARD.launches) == before


def test_ids_get_no_gradient_and_empty_batch():
    tables, ids, _ = _inputs(7, 3, 11, 4, 0)
    t = torch.from_numpy(tables).requires_grad_()
    out = tops.embedding_gather(t, torch.from_numpy(ids))
    assert out.shape == (0, 3, 4)
    out.sum().backward()
    assert t.grad.shape == tables.shape and not t.grad.any()


@pytest.mark.parametrize("batch,padded,n_seg,in_shared", [
    (0, 1024, 0, True), (1, 1024, 1, True), (33, 1024, 2, True), (4095, 4096, 128, True),
    (4096, 4096, 128, True), (4097, 5120, 129, True), (8192, 8192, 256, True),
    (8193, 9216, 257, False), (16384, 16384, 512, False),
])
def test_backward_scratch_follows_the_kernels_layout(batch, padded, n_seg, in_shared):
    """The backward's scratch as csrc/embedding_bag.cu reads it: each column
    padded to a multiple of the sort block's 1024 lanes; device-memory sort
    buffers only past 8192 padded rows; one segment per 32 sorted rows."""
    shapes = tops.backward_scratch(batch, 26, 64)
    assert list(shapes) == ["sorted", "sort_scratch", "seg", "tickets", "partials"]
    assert shapes["sorted"] == (26, 2, padded)
    assert shapes["sort_scratch"] == ((0,) if in_shared else (26, 4, padded))
    assert shapes["seg"] == (26, n_seg, 2) and shapes["tickets"] == (26, n_seg)
    assert shapes["partials"] == (2, 26, n_seg, 64)


@pytest.mark.parametrize("n_bytes,in_kernel", [(0, True), (26 * 5000 * 64 * 4, True),
                                               (2**30, True), (2**30 + 4, False),
                                               (26 * 10**6 * 64 * 4, False)])
def test_zeroing_route_by_gradient_size(n_bytes, in_kernel):
    """The sort's launch zeroes gradients up to 1 GiB (5K's 33 MB); a
    cudaMemsetAsync zeroes larger ones (1M's 6.66 GB)."""
    assert tops.zero_in_kernel(n_bytes) is in_kernel
