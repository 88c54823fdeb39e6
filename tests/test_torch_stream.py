"""The port's streaming preprocessing service (repro_torch.stream) on the
CPU, against the JAX package's service on the same requests: per-request
outputs bit for bit (dense at rtol 1e-6) on utf8 and binary feeds, the
same VocabState after absorb and refresh, the same splits, bucket choices
and request errors; backpressure, stop/drain and failure fan-out; the
no-recompile counter, waiting on ``stream.vocab_apply_total`` for a swap;
the chunk cache's hits; and the look-back scratch's epochs under threads.
Every wait carries a timeout."""

import queue
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import schema as jschema
from repro.core import vocab as jvocab
from repro.stream import StreamingPreprocessService as JService
from repro.stream import make_request as jmake_request
from repro.stream import scheduler as jscheduler
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import schema as tschema
from repro_torch.core import vocab as tvocab
from repro_torch.data import chunk_cache as cc
from repro_torch.data import synth as tsynth
from repro_torch.kernels import _scratch
from repro_torch.stream import CompositeRequest, StreamingPreprocessService, make_request
from repro_torch.stream import scheduler as tscheduler

BUCKETS = (32, 128, 512)
FIELDS = ("label", "dense", "sparse")
WAIT = 120  # seconds: the bound on every wait below


def _configs(cfg, fmt, **kw):
    kw = dict(schema=cfg.schema, max_rows_per_chunk=256, input_format=fmt, **kw)
    return JP.PipelineConfig(**kw), TP.PipelineConfig(device="cpu", **kw)


def _chunks(buf, table, fmt, lo, hi):
    """Rows [lo, hi) of the dataset as loop-① chunks of the format."""
    spans = tsynth.row_spans(buf)
    if fmt == "utf8":
        return list(tsynth.chunk_stream(buf[spans[lo, 0]: spans[hi - 1, 1]], 8192))
    return [{k: table[k][lo:hi] for k in FIELDS}]


def _states(cfg, fmt, buf, table, lo, hi, offset=0):
    """Loop ① over rows [lo, hi) from ``offset`` in both packages."""
    jcfg, tcfg = _configs(cfg, fmt)
    jpipe, tpipe = JP.PiperPipeline(jcfg), TP.PiperPipeline(tcfg)
    js = jpipe.init_state()
    js = jvocab.VocabState(first_pos=js.first_pos, rows_seen=jnp.int32(offset))
    ts = tpipe.init_state()
    ts.rows_seen.fill_(offset)
    for c in _chunks(buf, table, fmt, lo, hi):
        js = jpipe.vocab_step(js, jax.tree.map(jnp.asarray, c))
        ts = tpipe.vocab_step(ts, c)
    return js, ts


def _assert_state_equal(ts, js):
    first_pos, rows_seen, counts = interop.vocab_state_to_numpy(ts)
    np.testing.assert_array_equal(first_pos, np.asarray(js.first_pos))
    assert int(rows_seen) == int(js.rows_seen)
    assert (counts is None) == (js.counts is None)


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("label", "sparse"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
            assert g[k].dtype == np.int32
        np.testing.assert_allclose(g["dense"], np.asarray(w["dense"]), rtol=1e-6, atol=0)


def _sizes(seed, total, max_size):
    rng = np.random.default_rng(seed)
    sizes, left = [], total
    while left > 0:
        n = int(min(rng.integers(1, max_size + 1), left))
        sizes.append(n)
        left -= n
    return sizes


def _serve(svc, payloads):
    handles = [svc.submit(p) for p in payloads]
    svc.drain(timeout=WAIT)
    return [h.result(timeout=WAIT) for h in handles]


def _wait_applied(svc, n):
    counter = svc.registry.counter("stream.vocab_apply_total")
    deadline = time.monotonic() + WAIT
    while counter.value < n:
        assert time.monotonic() < deadline, "the vocabulary swap was never applied"
        time.sleep(0.002)


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_service_matches_the_jax_service(criteo_small, fmt):
    """The same seeded requests through both services: equal per-request
    outputs, equal packing counters."""
    buf, table, cfg = criteo_small
    js, ts = _states(cfg, fmt, buf, table, 0, cfg.rows)
    _assert_state_equal(ts, js)
    jcfg, tcfg = _configs(cfg, fmt)
    payloads = list(tsynth.request_payloads(buf, table, _sizes(5, cfg.rows, 300),
                                            input_format=fmt))
    outs, counts = [], []
    for svc in (StreamingPreprocessService(tcfg, ts, bucket_rows=BUCKETS, queue_depth=8),
                JService(jcfg, js, bucket_rows=BUCKETS, queue_depth=8)):
        with svc:
            outs.append(_serve(svc, payloads))
        snap = svc.registry.snapshot()
        counts.append((snap["stream.requests_total"]["value"], snap["stream.rows_total"]["value"]))
    _assert_outputs_equal(*outs)
    assert counts[0] == counts[1] == (len(payloads), cfg.rows)
    # and both reassemble to the offline loop-② table
    offline = list(TP.PiperPipeline(tcfg).transform_stream(
        tvocab.finalize(ts), _chunks(buf, table, fmt, 0, cfg.rows)))
    for k in FIELDS:
        want = np.concatenate([getattr(o, k)[o.valid].numpy() for o in offline])
        np.testing.assert_array_equal(np.concatenate([o[k] for o in outs[0]]), want)


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_absorb_and_refresh_match_the_jax_service(criteo_small, fmt):
    """Serve on a half-built vocabulary, absorb the second half (default
    offset), then refresh with a delta built elsewhere: after each swap
    (waited for on stream.vocab_apply_total) the merged VocabState equals
    the JAX service's and offline loop ① over the same rows in the same
    order, and the second half is served alike."""
    buf, table, cfg = criteo_small
    half = cfg.rows // 2
    js, ts = _states(cfg, fmt, buf, table, 0, half)
    jcfg, tcfg = _configs(cfg, fmt)
    payloads = list(tsynth.request_payloads(buf, table, [half, cfg.rows - half],
                                            input_format=fmt))
    # offline loop ① over every row, and a delta of rows [half, rows)
    # seeded at offset half, as a follow-up job would report it
    j_full, t_full = _states(cfg, fmt, buf, table, 0, cfg.rows)
    j_delta, t_delta = _states(cfg, fmt, buf, table, half, cfg.rows, offset=half)
    j_delta = jvocab.VocabState(first_pos=j_delta.first_pos,
                                rows_seen=j_delta.rows_seen - jnp.int32(half))
    t_delta = tvocab.VocabState(first_pos=t_delta.first_pos,
                                rows_seen=t_delta.rows_seen - half)
    results = []
    for svc in (StreamingPreprocessService(tcfg, ts, bucket_rows=BUCKETS, queue_depth=8),
                JService(jcfg, js, bucket_rows=BUCKETS, queue_depth=8)):
        with svc:
            first = _serve(svc, payloads[:1])
            absorber = threading.Thread(target=svc.absorb, args=(payloads[1],))
            absorber.start()
            absorber.join(timeout=WAIT)
            assert not absorber.is_alive()
            _wait_applied(svc, 1)
            after_absorb = svc.vocab_state
            served = _serve(svc, payloads[1:])
            svc.refresh_vocab(t_delta if isinstance(svc, StreamingPreprocessService)
                              else j_delta)
            _wait_applied(svc, 2)
            after_refresh = svc.vocab_state
            assert svc.registry.counter("stream.absorb_total").value == 1
        results.append((first, after_absorb, served, after_refresh))
    (t_first, t_abs, t_served, t_ref), (j_first, j_abs, j_served, j_ref) = results
    _assert_outputs_equal(t_first, j_first)
    _assert_outputs_equal(t_served, j_served)
    _assert_state_equal(t_abs, j_abs)
    _assert_state_equal(t_abs, j_full)  # absorb == offline loop ① in row order
    _assert_state_equal(t_ref, j_ref)
    # the refresh repeats rows the state holds: positions stay, rows add up
    np.testing.assert_array_equal(t_ref.first_pos.numpy(), t_full.first_pos.numpy())
    assert int(t_ref.rows_seen) == cfg.rows + (cfg.rows - half)


def test_absorb_rejects_what_the_reference_rejects(criteo_small):
    buf, table, cfg = criteo_small
    js, ts = _states(cfg, "utf8", buf, table, 0, 50)
    jcfg, tcfg = _configs(cfg, "utf8")
    big = next(tsynth.request_payloads(buf, table, [300]))
    for svc in (StreamingPreprocessService(tcfg, ts, bucket_rows=BUCKETS),
                JService(jcfg, js, bucket_rows=BUCKETS)):
        with pytest.raises(ValueError, match="exceeds the chunk geometry"):
            svc.absorb(big)
        with pytest.raises(OverflowError, match="position ceiling"):
            svc.absorb(big[: tsynth.row_spans(big)[0, 1]], row_offset=tvocab.MAX_ROWS)
        with pytest.raises(ValueError, match="different vocab layouts"):
            svc.refresh_vocab(type(svc.vocab_state)(
                first_pos=(torch.zeros((3, 7), dtype=torch.int32)
                           if isinstance(svc, StreamingPreprocessService)
                           else jnp.zeros((3, 7), jnp.int32)),
                rows_seen=svc.vocab_state.rows_seen))


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_split_and_bucket_choice_match_the_reference(criteo_small, fmt):
    buf, table, cfg = criteo_small
    js, ts = _states(cfg, fmt, buf, table, 0, 50)
    jcfg, tcfg = _configs(cfg, fmt)
    kw = dict(bucket_rows=(32, 64))
    tsched = tscheduler.MicroBatchScheduler(tcfg, tvocab.finalize(ts), **kw)
    jsched = jscheduler.MicroBatchScheduler(jcfg, jvocab.finalize(js), **kw)
    whole = next(tsynth.request_payloads(buf, table, [cfg.rows], input_format=fmt))
    tparts = tsched.split(make_request(whole, tcfg))
    jparts = jsched.split(jmake_request(whole, jcfg))
    assert [(p.n_rows, p.n_bytes) for p in tparts] == [(p.n_rows, p.n_bytes) for p in jparts]
    assert len(tparts) == -(-cfg.rows // 64)
    for tp, jp in zip(tparts, jparts):
        if fmt == "utf8":
            np.testing.assert_array_equal(tp.payload, jp.payload)
        else:
            for k in FIELDS:
                np.testing.assert_array_equal(tp.payload[k], jp.payload[k])
    for rows, nbytes in ((1, 0), (32, 0), (33, 0), (64, 0), (5, 32 * 640 + 1)):
        if fmt == "binary" and nbytes:
            continue
        assert tsched.select_bucket(rows, nbytes).rows == jsched.select_bucket(rows, nbytes).rows
    for sched in (tsched, jsched):
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            sched.select_bucket(65, 0)


def test_make_request_errors_match_the_reference():
    cases = [
        ("utf8", np.frombuffer(b"1\t2\t3", np.uint8), "whole rows"),
        ("utf8", np.zeros(0, np.uint8), "non-empty"),
        ("binary", {"label": np.zeros(4, np.int32), "dense": np.zeros((4, 3), np.int32),
                    "sparse": np.zeros((4, 26), np.int32)}, "schema"),
        ("binary", {"label": np.zeros((4, 1), np.int32), "dense": np.zeros((4, 13), np.int32),
                    "sparse": np.zeros((4, 26), np.int32)}, "1-D"),
        ("binary", {"label": np.zeros(0, np.int32), "dense": np.zeros((0, 13), np.int32),
                    "sparse": np.zeros((0, 26), np.int32)}, "at least one row"),
    ]
    for fmt, payload, match in cases:
        for mk, cfg in ((make_request, TP.PipelineConfig(input_format=fmt, device="cpu")),
                        (jmake_request, JP.PipelineConfig(schema=jschema.CRITEO,
                                                          input_format=fmt))):
            with pytest.raises(ValueError, match=match):
                mk(payload, cfg)


def test_single_oversized_row_rejected():
    schema = tschema.TableSchema(n_dense=2, n_sparse=2, vocab_range=64)
    pc = TP.PipelineConfig(schema=schema, device="cpu")
    svc = StreamingPreprocessService(
        pc, tvocab.VocabState.init(2, 64, device="cpu"), bucket_rows=(4,), bytes_per_row=8,
        queue_depth=2)
    giant_row = ("1\t" + "9" * 40 + "\t2\tabc\tdef\n").encode()
    with svc:
        with pytest.raises(ValueError, match="no row-aligned split"):
            svc.submit(np.frombuffer(giant_row * 8, np.uint8))


def _service(criteo_small, fmt="utf8", **kw):
    buf, table, cfg = criteo_small
    _, ts = _states(cfg, fmt, buf, table, 0, cfg.rows)
    _, tcfg = _configs(cfg, fmt)
    return StreamingPreprocessService(tcfg, ts, **{"bucket_rows": BUCKETS, **kw})


def test_backpressure_and_oversized_split(criteo_small):
    buf, table, cfg = criteo_small
    svc = _service(criteo_small, bucket_rows=(32, 128), queue_depth=2)
    with svc:
        handles = [svc.submit(p) for p in tsynth.request_payloads(buf, table, [4] * 50)]
        composite = svc.submit(next(tsynth.request_payloads(buf, table, [cfg.rows])))
        svc.drain(timeout=WAIT)
        assert all(h.done for h in handles)
        assert isinstance(composite, CompositeRequest)
        assert len(composite.parts) == -(-cfg.rows // 128)
        whole = composite.result(timeout=WAIT)
        assert composite.done and composite.latency_s is not None
        snap = svc.metrics.snapshot()
    assert snap["requests"] == 50 + len(composite.parts)
    assert snap["rows"] == 200 + cfg.rows
    assert snap["p99_ms"] >= snap["p50_ms"] >= 0
    assert svc.registry.get("stream.backpressure_wait_s").count >= 50
    parts = np.concatenate([h.result(timeout=WAIT)["label"] for h in handles])
    np.testing.assert_array_equal(parts, whole["label"][:200])


def test_stop_drain_and_refusals(criteo_small):
    buf, table, _ = criteo_small
    svc = _service(criteo_small)
    payload = next(tsynth.request_payloads(buf, table, [10]))
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(payload)
    svc.start()
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
    h = svc.submit(payload)
    svc.stop()
    assert h.done and h.result(timeout=WAIT)["label"].shape == (10,)
    svc.stop()  # idempotent
    with pytest.raises(RuntimeError):
        svc.submit(payload)
    # a full ingress with no loop serving it: submit times out, drain
    # times out, and stop fails the stranded request
    idle = _service(criteo_small, queue_depth=1)
    idle._thread = threading.Thread(target=lambda: None)  # started, but no loop
    stranded = idle.submit(payload)
    with pytest.raises(queue.Full):
        idle.submit(payload, timeout=0.05)
    with pytest.raises(TimeoutError, match="drain timed out"):
        idle.drain(timeout=0.05)
    idle._thread = None
    idle.stop()
    with pytest.raises(RuntimeError, match="stopped before completion"):
        stranded.result(timeout=WAIT)
    idle.drain(timeout=WAIT)  # nothing outstanding any more


def test_a_failing_step_fails_every_request(criteo_small):
    """A transform that raises fails every request in flight and queued,
    and later submits are refused with the cause."""
    buf, table, _ = criteo_small
    svc = _service(criteo_small, bucket_rows=(32,), queue_depth=64)
    boom = RuntimeError("device fault")

    def fail(chunk):
        raise boom

    for b in svc.scheduler.buckets:
        b.transform = type("Failing", (), {"__call__": staticmethod(fail)})()
    payloads = list(tsynth.request_payloads(buf, table, [3] * 20))
    with svc:
        handles = []
        for p in payloads:
            try:
                handles.append(svc.submit(p))
            except RuntimeError:
                break
        for h in handles:
            with pytest.raises(RuntimeError, match="device fault"):
                h.result(timeout=WAIT)
        with pytest.raises(RuntimeError, match="failed"):
            svc.drain(timeout=WAIT)
        with pytest.raises(RuntimeError, match="stopping|failed"):
            svc.submit(payloads[0])
    assert isinstance(svc._error, RuntimeError) and svc._error is boom


def test_no_recompile_after_warmup(criteo_small):
    """stream.recompiles_total is len(buckets) after one warm-up batch per
    bucket, and stays there through the ladder and a vocabulary swap
    (waited for on stream.vocab_apply_total, not on vocab_state)."""
    buf, table, cfg = criteo_small
    svc = _service(criteo_small)
    recompiles = svc.registry.counter("stream.recompiles_total")
    with svc:
        svc.warmup(next(tsynth.request_payloads(buf, table, [min(c, cfg.rows)]))
                   for c in BUCKETS)
        assert recompiles.value == svc.compile_cache_size() == len(BUCKETS)
        assert svc.metrics.snapshot()["requests"] == 0
        rng = np.random.default_rng(7)
        sizes = [int(rng.integers(max(1, c // 2), min(c, cfg.rows) + 1))
                 for c in BUCKETS for _ in range(4)]
        for out in [svc.submit(next(tsynth.request_payloads(buf, table, [n]))) for n in sizes]:
            assert out.result(timeout=WAIT)["label"].shape[0] > 0
        assert recompiles.value == len(BUCKETS)
        _, delta = _states(cfg, "utf8", buf, table, 0, cfg.rows, offset=cfg.rows)
        svc.refresh_vocab(tvocab.VocabState(delta.first_pos, delta.rows_seen - cfg.rows))
        _wait_applied(svc, 1)
        for c in BUCKETS:
            svc.submit(next(tsynth.request_payloads(buf, table, [min(c, cfg.rows)])))
        svc.drain(timeout=WAIT)
        assert recompiles.value == svc.compile_cache_size() == len(BUCKETS)
        assert svc.registry.get("stream.vocab_swap_s").count == 1
        assert svc.last_swap_seconds() is None  # no device events on the CPU


def test_cache_hits_are_identical_and_swaps_invalidate(criteo_small):
    buf, table, cfg = criteo_small
    cache = cc.ChunkCache(capacity_bytes=1 << 24)
    svc = _service(criteo_small, cache=cache)
    payloads = list(tsynth.request_payloads(buf, table, _sizes(3, cfg.rows, 100)))
    with svc:
        first = _serve(svc, payloads)
        batches = svc.registry.counter("stream.batches_total").value
        again = _serve(svc, payloads)
        assert svc.registry.counter("stream.batches_total").value == batches  # no dispatch
        assert cache.stats()["hits_total"] == len(payloads)
        # a delta with one value the vocabulary lacks: the table changes
        delta = tvocab.VocabState.init(*svc.vocab_state.first_pos.shape, device="cpu")
        absent = int(torch.nonzero(svc.vocab_state.first_pos[0] == tvocab.NEVER)[0])
        delta.first_pos[0, absent] = cfg.rows
        delta.rows_seen.fill_(1)
        svc.refresh_vocab(delta)
        _wait_applied(svc, 1)
        _serve(svc, payloads[:2])
        assert cache.stats()["hits_total"] == len(payloads)  # new digest → misses
        assert svc.registry.get("stream.vocab_digest_s").count == 2  # construction + swap
    for a, b in zip(first, again):
        for k in FIELDS:
            np.testing.assert_array_equal(a[k], b[k])
            assert not np.shares_memory(a[k], b[k])


def test_results_are_the_requests_own_memory(criteo_small):
    """Routed results own their memory: a later batch through the same
    staging slot leaves them unchanged."""
    buf, table, cfg = criteo_small
    svc = _service(criteo_small, "binary", bucket_rows=(128,))
    pay = list(tsynth.request_payloads(buf, table, [100, 100, 100, 100], input_format="binary"))
    with svc:
        outs = _serve(svc, pay[:1])
        kept = {k: v.copy() for k, v in outs[0].items()}
        _serve(svc, pay[1:])
    slots = [slot.chunk[k].numpy() for slot in svc.scheduler.buckets[0].slots for k in FIELDS]
    for k in FIELDS:
        np.testing.assert_array_equal(outs[0][k], kept[k])
        assert not any(np.shares_memory(outs[0][k], a) for a in slots)


def test_frozen_transform_counts_signatures(criteo_small):
    """The scheduler's dispatch counts each bucket's input signature once:
    a second batch of one bucket adds nothing, a batch of another adds one,
    and the frozen transform itself keeps no count (the offline loops run
    it too)."""
    buf, table, cfg = criteo_small
    _, ts = _states(cfg, "binary", buf, table, 0, cfg.rows)
    _, tcfg = _configs(cfg, "binary")
    sched = tscheduler.MicroBatchScheduler(tcfg, tvocab.finalize(ts), bucket_rows=(32, 64))
    recompiles = sched.registry.counter("stream.recompiles_total")

    def dispatch(lo, hi):
        req = make_request({k: table[k][lo:hi] for k in FIELDS}, tcfg)
        sched.dispatch(sched.assemble([req]))

    dispatch(0, 20)
    dispatch(20, 30)
    assert sched.compile_cache_size() == recompiles.value == 1
    dispatch(0, 40)
    assert sched.compile_cache_size() == recompiles.value == 2
    assert not hasattr(sched.buckets[0].transform, "compile_cache_size")


def test_scan_epochs_are_distinct_and_consecutive_under_threads():
    """8 threads taking epochs from one scratch at once get each epoch of
    1..N exactly once (the lock makes the read-modify-write atomic)."""
    scratch = _scratch.ScanScratch(4, torch.device("cpu"))
    per_thread = 2000
    got = [[] for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda out=out: out.extend(
            scratch.next_epoch() for _ in range(per_thread))) for out in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    epochs = sorted(e for out in got for e in out)
    assert epochs == list(range(1, 8 * per_thread + 1))
    assert all(out == sorted(out) for out in got)  # each thread's in its own order


def test_scratch_entries_are_made_once_per_stream_and_counted():
    """Threads asking at once for one stream's scratch get one entry, made
    once; each thread counts only the entries it made."""
    dev = torch.device("cpu")
    stream = 1 << 40  # a stream handle no other test uses
    made, counts = [], []

    def ask():
        before = _scratch.made_here()
        made.append(_scratch.scan_scratch(dev, stream, 8))
        counts.append(_scratch.made_here() - before)

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert len({id(s) for s in made}) == 1 and sorted(counts) == [0] * 7 + [1]
    before = _scratch.made_here()
    _scratch.scan_scratch(dev, stream, 16)  # regrown
    _scratch.scan_scratch(dev, stream, 16)  # kept
    _scratch.pending(dev, stream, 4)
    _scratch.tally(dev, stream)
    _scratch.tally(dev, stream)
    assert _scratch.made_here() == before + 3
