"""The port's observability layer (repro_torch.obs) on the CPU, against the
JAX package's: counters, gauges and histogram quantiles equal the
reference's on the same observations, the port's trace passes the
reference's schema check, the stall buckets sum to the wall time, and the
engine's spans and counters change no output (the fused_small.npz golden
is met with tracing and stage spans on)."""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.obs import counters as jcounters
from repro.obs import stall as jstall
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.core import pipeline as TP
from repro_torch.data import synth as tsynth
from repro_torch.obs import counters as tcounters
from repro_torch.obs import stall as tstall
from repro_torch.obs import trace as ttrace
from repro_torch.stream import StreamingPreprocessService
from repro_torch.stream import metrics as tmetrics

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fused_small.npz")


@pytest.fixture
def instrumented():
    """Tracing and stage spans on for one test; the global toggles and
    the tracer's ring restored afterwards."""
    was_enabled, was_stage = obs.enabled(), obs.stage_spans()
    obs.enable()
    obs.set_stage_spans(True)
    obs.tracer().reset()
    yield obs.tracer()
    obs.tracer().reset()
    obs.set_stage_spans(was_stage)
    if not was_enabled:
        obs.disable()


def _feed(registry, counters_lib, observations):
    c = registry.counter("c")
    g = registry.gauge("g")
    h = registry.histogram("h", reservoir=64)
    hd = registry.histogram("h_default")
    for v in observations:
        c.add(abs(v))
        g.set(v)
        h.observe(v)
        hd.observe(v)
    assert counters_lib.DEFAULT_RESERVOIR == 4096
    return registry.snapshot(), h.percentiles((10.0, 50.0, 90.0, 99.0))


@pytest.mark.parametrize("n", [10, 64, 5000], ids=lambda n: f"n{n}")
def test_instruments_equal_the_reference(n):
    """The same observations give the same snapshot, quantiles included:
    past the reservoir, both sample with random.Random(name)."""
    obs_ = np.random.default_rng(n).normal(size=n).tolist()
    got = _feed(tcounters.Registry(), tcounters, obs_)
    want = _feed(jcounters.Registry(), jcounters, obs_)
    assert got == want


def test_counter_and_registry_errors_match():
    for lib in (tcounters, jcounters):
        with pytest.raises(ValueError, match="cannot decrease"):
            lib.Counter("c").add(-1)
        r = lib.Registry()
        r.counter("x")
        with pytest.raises(ValueError, match="already registered as counter"):
            r.gauge("x")
        with pytest.raises(ValueError, match="positive reservoir"):
            lib.Histogram("h", reservoir=0)


def test_registry_threadsafe_concurrent_adds():
    r = tcounters.Registry()
    c = r.counter("n")

    def work():
        for _ in range(2000):
            c.add(1)
            r.histogram("lat").observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 16000 and r.get("lat").count == 16000


def test_registry_jsonl_export(tmp_path):
    r = tcounters.Registry()
    r.counter("a").add(2)
    path = tmp_path / "m.jsonl"
    r.export_jsonl(str(path), extra={"run": 1})
    r.export_jsonl(str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and '"run": 1' in lines[0]


def _spans(tracer):
    with tracer.span("outer", cat="stream", bucket_rows=1024):
        with tracer.span("inner", route="fused/device"):
            pass
        tracer.instant("mark", n=3)

    def other():
        with tracer.span("thread"):
            pass

    t = threading.Thread(target=other, name="second")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_port_trace_passes_the_reference_validator(tmp_path):
    tracer = ttrace.Tracer()
    _spans(tracer)
    doc = tracer.to_chrome()
    assert jtrace.validate_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert {"outer", "inner", "mark", "thread", "thread_name", "process_name"} <= set(names)
    # the module's schema check, on the exported file
    path = tmp_path / "t.json"
    tracer.export(str(path))
    assert ttrace._main([str(path)]) == 0
    assert jtrace._main([str(path)]) == 0


def test_tracer_ring_disable_and_validator_agree():
    tracer = ttrace.Tracer(max_events=4)
    for i in range(10):
        with tracer.span(f"s{i}"):
            pass
    assert len(tracer.events()) == 4 and tracer.dropped == 6
    tracer.enabled = False
    with tracer.span("off"):
        pass
    assert len(tracer.events()) == 4
    for bad in ({}, {"traceEvents": []}, {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                                            "tid": 1, "ts": 0, "dur": -1}]}):
        assert ttrace.validate_trace(bad) == jtrace.validate_trace(bad) != []


@pytest.mark.parametrize("kind", ["instant", "span"])
def test_reset_racing_an_event_stamps_it_with_the_new_epoch(monkeypatch, kind):
    """A reset() that lands between an event's clock reading and its
    append moves the epoch under the tracer's lock; the event's ts is
    taken against the epoch it lands beside (the new one), never the
    old one 1000 s back. The reset is forced into that gap through the
    labels' stringification, which runs between the two."""
    tracer = ttrace.Tracer()
    tracer.reset()
    tracer._t_epoch -= 1000.0  # an epoch long ago
    real = ttrace._argstr

    def resetting(v):
        tracer.reset()
        return real(v)

    monkeypatch.setattr(ttrace, "_argstr", resetting)
    if kind == "instant":
        tracer.instant("mark", x=1)
    else:
        with tracer.span("block", x=1):
            pass
    (event,) = tracer.events()
    assert -1e6 < event["ts"] < 1e6, event


def test_reset_racing_instant_from_threads_keeps_one_epoch():
    """Threads record instants while the main thread resets: every event
    left in the ring after the last reset is stamped within the time
    since that reset (a lost epoch read would put one ~1000 s out)."""
    import sys
    import time

    tracer = ttrace.Tracer(max_events=1 << 16)
    stop = threading.Event()

    def record():
        while not stop.is_set():
            tracer.instant("i")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=record) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for _ in range(200):
            tracer._t_epoch -= 1000.0  # each round's epoch starts long ago
            tracer.reset()
        t_last = time.perf_counter()
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    span_us = (time.perf_counter() - t_last + 1.0) * 1e6
    assert all(e["ts"] < span_us for e in tracer.events())


def test_span_names_reach_the_profiler_host_track():
    """Inside a torch.profiler session a span is also a record_function,
    so its name is on the profiler's host track; outside one, none is
    entered."""
    tracer = ttrace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("stream/dispatch"):
            torch.ones(4).sum()
    assert "stream/dispatch" in {e.key for e in prof.key_averages()}
    assert not tracer.nvtx


def test_stall_clock_matches_the_reference():
    for lib, counters_lib in ((tstall, tcounters), (jstall, jcounters)):
        r = counters_lib.Registry()
        clock = lib.StallClock(r)
        clock.start()
        for b in lib.BUCKETS:
            clock.lap(b)
        clock.stop()
        rep = lib.report(r)
        assert rep["attributed_s"] == rep["wall_s"] > 0
        assert set(rep["buckets_s"]) == set(lib.BUCKETS)
    assert tstall.BUCKETS == jstall.BUCKETS and tstall.E2E_BUCKETS == jstall.E2E_BUCKETS
    empty = tstall.report(tcounters.Registry())
    assert empty == jstall.report(jcounters.Registry())


def test_service_stall_buckets_sum_to_wall(criteo_small):
    buf, _, cfg = criteo_small
    pc = TP.PipelineConfig(schema=cfg.schema, device="cpu")
    state = TP.PiperPipeline(pc).build_state_stream(tsynth.chunk_stream(buf, 16384))
    spans = tsynth.row_spans(buf)
    svc = StreamingPreprocessService(pc, state, bucket_rows=(32, 128), queue_depth=8)
    with svc:
        handles = [svc.submit(buf[spans[i * 8, 0]: spans[i * 8 + 7, 1]]) for i in range(20)]
        svc.drain(timeout=120)
        for h in handles:
            assert h.result(timeout=60)["label"].shape[0] == 8
    rep = svc.stall_report()
    assert rep["wall_s"] > 0
    assert rep["attributed_s"] == pytest.approx(rep["wall_s"], rel=0.05)
    assert sum(rep["buckets_s"].values()) == pytest.approx(rep["wall_s"], rel=0.05)
    assert rep["buckets_s"]["device_dispatch"] > 0
    snap = svc.registry.snapshot()
    assert snap["stream.batches_total"]["value"] > 0
    assert 0.0 < snap["stream.bucket_occupancy"]["mean"] <= 1.0


def test_service_metrics_is_a_bounded_registry_view():
    r = tcounters.Registry()
    m = tmetrics.ServiceMetrics(r)
    n = tmetrics.LATENCY_RESERVOIR + 500
    m.note_submit(0.0)
    for i in range(n):
        m.record(0.001 * (i % 10 + 1), 4, now=float(i))
    snap = m.snapshot()
    assert snap["requests"] == n and snap["rows"] == 4 * n
    assert len(r.get("stream.request_latency_s")._samples) == tmetrics.LATENCY_RESERVOIR
    assert snap["p99_ms"] >= snap["p50_ms"] > 0
    m.reset()
    assert m.snapshot()["requests"] == 0 and r.get("stream.requests_total").value == 0


def _digest(label, sparse):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(label, np.int32).tobytes())
    h.update(np.ascontiguousarray(sparse, np.int32).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("stage", [False, True], ids=["spans", "stage_spans"])
def test_golden_met_with_tracing_on(instrumented, stage):
    """Spans and counters change no output: the golden digest, loop-①
    state included, with tracing on (and stage spans)."""
    obs.set_stage_spans(stage)
    g = np.load(GOLDEN)
    cb = int(g["chunk_bytes"])
    pipe = TP.PiperPipeline(TP.PipelineConfig(
        chunk_bytes=cb, max_rows_per_chunk=int(g["max_rows_per_chunk"]), device="cpu"))
    outs = list(pipe.run_stream(lambda: tsynth.chunk_stream(g["buf"], cb)))
    label = np.concatenate([o.label[o.valid].numpy() for o in outs])
    sparse = np.concatenate([o.sparse[o.valid].numpy() for o in outs])
    dense = np.concatenate([o.dense[o.valid].numpy() for o in outs])
    assert _digest(label, sparse) == str(g["digest"])
    np.testing.assert_allclose(dense, g["dense"], rtol=1e-6)
    names = {e["name"] for e in obs.tracer().events()}
    assert {"loop1/chunk", "loop2/chunk"} <= names
    assert ({"decode", "vocab_update", "transform"} <= names) == stage
    by_name = {e["name"]: e for e in obs.tracer().events()}
    for name in ("loop1/chunk", "loop2/chunk"):
        assert by_name[name]["args"]["engine"] == "piper"
        assert by_name[name]["args"]["route"] == "unfused"  # the CPU's plain chain
    assert jtrace.validate_trace(obs.tracer().to_chrome()) == []


def test_engine_loops_record_nothing_with_the_tracer_off(criteo_small):
    """The process tracer starts off: the offline loops then record no
    span, and still add their chunks and bytes to the counters once a
    loop call."""
    buf, _, cfg = criteo_small
    assert not obs.enabled() and not obs.stage_spans()
    before_events = len(obs.tracer().events())
    reg = obs.metrics()
    names = [f"pipeline.loop{i}_{k}_total" for i in (1, 2) for k in ("chunks", "bytes")]
    before = {n: reg.counter(n).value for n in names}
    pipe = TP.PiperPipeline(TP.PipelineConfig(schema=cfg.schema, max_rows_per_chunk=256,
                                              device="cpu"))
    chunks = list(tsynth.chunk_stream(buf, 16384))
    outs = list(pipe.run_stream(lambda: iter(chunks)))
    assert len(outs) == len(chunks)
    assert len(obs.tracer().events()) == before_events
    for i in (1, 2):
        assert reg.counter(f"pipeline.loop{i}_chunks_total").value - before[
            f"pipeline.loop{i}_chunks_total"] == len(chunks)
        assert reg.counter(f"pipeline.loop{i}_bytes_total").value - before[
            f"pipeline.loop{i}_bytes_total"] == sum(c.size for c in chunks)


def test_engine_counters_accumulate(criteo_small, instrumented):
    buf, _, cfg = criteo_small
    reg = obs.metrics()
    names = [f"pipeline.loop{i}_{k}_total" for i in (1, 2) for k in ("chunks", "rows", "bytes")]
    before = {n: reg.counter(n).value for n in names}
    pipe = TP.PiperPipeline(TP.PipelineConfig(schema=cfg.schema, max_rows_per_chunk=256,
                                              device="cpu"))
    chunks = list(tsynth.chunk_stream(buf, 16384))
    list(pipe.run_stream(lambda: iter(chunks)))
    grew = {n: reg.counter(n).value - before[n] for n in names}
    for i in (1, 2):
        assert grew[f"pipeline.loop{i}_chunks_total"] == len(chunks)
        assert grew[f"pipeline.loop{i}_rows_total"] == cfg.rows
        assert grew[f"pipeline.loop{i}_bytes_total"] == sum(c.size for c in chunks) >= len(buf)
