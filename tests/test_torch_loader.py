"""The port's host feeds and prefetchers (repro_torch.data.loader) against
the JAX package's (repro.data.loader): ``TabularChunkFeed``'s layouts on
the same buffer, and the ``Prefetcher`` / ``DevicePrefetcher`` contract of
the reference's tests (order, error re-raise, deadline, idempotent stop,
bad depth), the device prefetcher on the CPU. Every wait carries a
timeout."""

import threading
import time

import numpy as np
import pytest
import torch

from repro.data import loader as jloader
from repro.data import synth as jsynth
from repro_torch.data import loader as tloader
from repro_torch.data import synth as tsynth

WAIT = 10.0  # seconds: the bound on every get below


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("rows,chunk_bytes", [(200, 8192), (37, 4096)])
def test_tabular_chunk_feed_matches_reference(n_shards, rows, chunk_bytes):
    """stacked, offsets, shard_stacks() and the iteration equal the
    reference's on the same buffer, bit for bit."""
    buf, _ = tsynth.make_dataset(tsynth.SynthConfig(rows=rows, seed=4))
    jbuf, _ = jsynth.make_dataset(jsynth.SynthConfig(rows=rows, seed=4))
    np.testing.assert_array_equal(buf, jbuf)
    got = tloader.TabularChunkFeed(buf, chunk_bytes, n_row_shards=n_shards)
    want = jloader.TabularChunkFeed(jbuf, chunk_bytes, n_row_shards=n_shards)
    assert (got.n_steps, got.n_shards, got.chunk_bytes) == (
        want.n_steps, want.n_shards, want.chunk_bytes)
    np.testing.assert_array_equal(got.stacked, want.stacked)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.offsets.dtype == np.int32
    for g, w in zip(got.shard_stacks(), want.shard_stacks()):
        np.testing.assert_array_equal(g, w)
        assert g.flags.c_contiguous
    pairs = list(got)
    assert len(pairs) == got.n_steps
    for (gc, go), (wc, wo) in zip(pairs, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(go, wo)


def _prefetchers():
    return [
        ("prefetcher", lambda fn, depth: tloader.Prefetcher(fn, depth=depth)),
        ("device_cpu", lambda fn, depth: tloader.DevicePrefetcher(fn, depth=depth,
                                                                  device="cpu")),
    ]


@pytest.mark.parametrize("make", [m for _, m in _prefetchers()],
                         ids=[n for n, _ in _prefetchers()])
def test_prefetcher_orders_batches(make):
    fn = tloader.TokenBatches(vocab_size=10, batch=1, seq=4, seed=0)
    pf = make(fn, 3).start(start_step=7)
    try:
        for want in (7, 8, 9, 10, 11):
            step, batch = pf.get(timeout=WAIT)
            assert step == want
            np.testing.assert_array_equal(np.asarray(batch["tokens"]), fn(step)["tokens"])
    finally:
        pf.stop()


@pytest.mark.parametrize("make", [m for _, m in _prefetchers()],
                         ids=[n for n, _ in _prefetchers()])
def test_prefetcher_propagates_batch_fn_error(make):
    """A batch_fn exception surfaces in get() as a RuntimeError caused by
    it, after the batches made before it."""

    def bad_fn(step):
        if step >= 2:
            raise ValueError("boom at step 2")
        return {"x": np.zeros(1, np.float32)}

    pf = make(bad_fn, 1).start()
    try:
        got = []
        with pytest.raises(RuntimeError, match="batch_fn failed") as ei:
            for _ in range(5):
                got.append(pf.get(timeout=WAIT)[0])
        assert got == [0, 1]
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        pf.stop()


@pytest.mark.parametrize("make", [m for _, m in _prefetchers()],
                         ids=[n for n, _ in _prefetchers()])
def test_prefetcher_stop_idempotent(make):
    fn = tloader.TokenBatches(vocab_size=10, batch=1, seq=4, seed=0)
    pf = make(fn, 2).start()
    assert pf.get(timeout=WAIT)[0] == 0
    pf.stop()
    pf.stop()  # a second stop is a no-op, not an error


def test_prefetcher_get_timeout_is_a_deadline():
    """A producer that makes nothing: get(timeout) raises TimeoutError after
    about that long, not after a poll interval or never."""
    release = threading.Event()

    def slow(step):
        release.wait(WAIT)
        return {"x": np.zeros(1)}

    pf = tloader.Prefetcher(slow, depth=1).start()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            pf.get(timeout=0.3)
        assert 0.25 <= time.monotonic() - t0 < 2.0
    finally:
        release.set()
        pf.stop()


def test_prefetchers_reject_bad_depth():
    fn = tloader.TokenBatches(vocab_size=10, batch=1, seq=4, seed=0)
    with pytest.raises(ValueError, match="depth"):
        tloader.Prefetcher(fn, depth=0)
    with pytest.raises(ValueError, match="depth"):
        tloader.DevicePrefetcher(fn, depth=-1, device="cpu")


def test_device_prefetcher_on_the_cpu_hands_out_its_own_copies():
    """device='cpu': torch tensors over a copy of each array, so the
    producer's later writes cannot reach a batch already handed out."""
    shared = np.zeros(4, np.int32)

    def fn(step):
        shared[:] = step
        return {"x": shared}

    pf = tloader.DevicePrefetcher(fn, depth=2, device="cpu").start()
    try:
        batches = [pf.get(timeout=WAIT) for _ in range(4)]
    finally:
        pf.stop()
    for step, batch in batches:
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        assert torch.equal(batch["x"], torch.full((4,), step, dtype=torch.int32))


def test_device_prefetcher_defaults_to_the_card(monkeypatch):
    """No fallback: the default device is the card, and without one the
    constructor raises."""
    fn = tloader.TokenBatches(vocab_size=10, batch=1, seq=4, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.DevicePrefetcher(fn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.PinnedStager("cuda", slots=2)


def test_prefetcher_stop_returns_while_batch_fn_blocks():
    """A producer blocked inside batch_fn (a stalled service) does not hang
    stop(): the join gives up after about a second."""
    release = threading.Event()

    def fn(step):
        if step == 1:
            release.wait(WAIT)
        return {"x": np.zeros(1)}

    pf = tloader.Prefetcher(fn, depth=1).start()
    try:
        assert pf.get(timeout=WAIT)[0] == 0
        t0 = time.monotonic()
        pf.stop()
        assert time.monotonic() - t0 < 3.0
    finally:
        release.set()
