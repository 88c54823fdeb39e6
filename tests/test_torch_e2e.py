"""The port's service-fed training input (repro_torch.train.input_pipeline.
TrainInputPipeline) and its end-to-end launcher against the JAX package's
on the same payloads, on the CPU: the batches bit for bit (dense at rtol
1e-6) over an epoch wrap, overlap on and off alike, a failing or stopped
service surfacing in ``next()`` without a hang, the stall split and the
``e2e.*`` counters, DLRM weights bit-identical across overlap and chunk
cache, and the loss curve against the reference's jitted run. Every wait
carries a timeout."""

import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.core import schema as jschema
from repro.data import synth as jsynth
from repro.models import dlrm as jdlrm
from repro.stream import StreamingPreprocessService as JService
from repro.train import input_pipeline as jinput
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import interop, obs
from repro_torch.core import pipeline as TP
from repro_torch.core import schema as tschema
from repro_torch.data import chunk_cache as cc
from repro_torch.data import synth as tsynth
from repro_torch.launch import train_dlrm_e2e
from repro_torch.models import dlrm as tdlrm
from repro_torch.stream import StreamingPreprocessService
from repro_torch.train import input_pipeline as tinput
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train.tree import leaves

PAYLOAD_ROWS = 64
N_PAYLOADS = 4
WAIT = 120  # seconds: the bound on every wait below
SCHEMA = dict(n_dense=4, n_sparse=6, vocab_range=100)
MODEL = dict(n_dense=4, n_sparse=6, vocab_range=100, embed_dim=4, bottom_mlp=(8, 4),
             top_mlp=(8, 1))


@pytest.fixture(scope="module")
def world():
    """The same small non-Criteo dataset, loop-① state and payloads in both
    packages."""
    kw = dict(chunk_bytes=1 << 14, max_rows_per_chunk=PAYLOAD_ROWS)
    jsch, tsch = jschema.TableSchema(**SCHEMA), tschema.TableSchema(**SCHEMA)
    jbuf, jtable = jsynth.make_dataset(
        jsynth.SynthConfig(schema=jsch, rows=N_PAYLOADS * PAYLOAD_ROWS, seed=3))
    buf, table = tsynth.make_dataset(
        tsynth.SynthConfig(schema=tsch, rows=N_PAYLOADS * PAYLOAD_ROWS, seed=3))
    np.testing.assert_array_equal(buf, jbuf)
    jcfg = JP.PipelineConfig(schema=jsch, **kw)
    tcfg = TP.PipelineConfig(schema=tsch, device="cpu", **kw)
    jstate = JP.PiperPipeline(jcfg).build_state_stream(jsynth.chunk_stream(jbuf, 1 << 14))
    tstate = TP.PiperPipeline(tcfg).build_state_stream(tsynth.chunk_stream(buf, 1 << 14))
    payloads = list(tsynth.request_payloads(buf, table, [PAYLOAD_ROWS] * N_PAYLOADS))
    return {"jcfg": jcfg, "jstate": jstate, "tcfg": tcfg, "tstate": tstate,
            "payloads": payloads}


def _service(world, cache=None):
    return StreamingPreprocessService(world["tcfg"], world["tstate"],
                                      bucket_rows=(PAYLOAD_ROWS,), cache=cache).start()


def _port_batches(svc, world, overlap, batch_rows=48, n_steps=6):
    pipe_in = tinput.TrainInputPipeline(svc, lambda: iter(world["payloads"]),
                                        batch_rows=batch_rows, n_steps=n_steps,
                                        overlap=overlap, device="cpu")
    return [dict(b) for b in pipe_in], pipe_in


def _consume_in_thread(pipe_in):
    """Iterate ``pipe_in`` on another thread, bounded by WAIT; returns the
    batches and the exception it raised."""
    got, errors = [], []

    def consume():
        try:
            for b in pipe_in:
                got.append(b)
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            errors.append(e)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "the input pipeline hung"
    return got, errors


def test_service_fed_batches_match_reference_over_an_epoch_wrap(world):
    """6 batches of 48 rows = 288 rows > one 256-row epoch: the port's
    batches (overlap off and on) equal the reference's
    ``TrainInputPipeline(overlap=False)`` on the JAX service, labels and ids
    bit for bit, dense at Piper's rtol 1e-6."""
    jsvc = JService(world["jcfg"], world["jstate"], bucket_rows=(PAYLOAD_ROWS,)).start()
    try:
        want = [jax.tree.map(np.asarray, b) for b in jinput.TrainInputPipeline(
            jsvc, lambda: iter(world["payloads"]), batch_rows=48, n_steps=6, overlap=False)]
    finally:
        jsvc.stop()
    svc = _service(world)
    try:
        for overlap in (False, True):
            got, pipe_in = _port_batches(svc, world, overlap)
            assert len(got) == len(want) == 6
            for g, w in zip(got, want):
                assert set(g) == set(tinput.FIELDS)
                for k in ("label", "sparse"):
                    assert g[k].dtype == torch.int32
                    np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
                np.testing.assert_allclose(g["dense"].numpy(), w["dense"], rtol=1e-6, atol=0)
            assert pipe_in.registry.get("e2e.epochs_total").value == 2
    finally:
        svc.stop()


def test_overlap_on_and_off_give_the_same_batches(world):
    svc = _service(world)
    try:
        off, _ = _port_batches(svc, world, False, batch_rows=100, n_steps=5)
        on, _ = _port_batches(svc, world, True, batch_rows=100, n_steps=5)
    finally:
        svc.stop()
    assert len(off) == len(on) == 5
    for a, b in zip(off, on):
        for k in tinput.FIELDS:
            assert a[k].shape[0] == 100
            assert torch.equal(a[k], b[k]), k


def test_stall_report_and_counters(world):
    """The buckets sum to the attributed wall; the counters count what was
    delivered (6 × 48 rows over two epochs of the payload stream)."""
    svc = _service(world)
    try:
        _, pipe_in = _port_batches(svc, world, True)
    finally:
        svc.stop()
    rep = pipe_in.stall_report()
    assert set(rep["fractions"]) == {"input_wait", "train_step"}
    assert rep["attributed_s"] == pytest.approx(sum(rep["buckets_s"].values()), abs=1e-5)
    assert rep["wall_s"] == pytest.approx(rep["attributed_s"], rel=0.05)
    assert sum(rep["fractions"].values()) == pytest.approx(1.0, abs=1e-3)
    reg = pipe_in.registry
    assert reg.get("e2e.batches_total").value == 6
    assert reg.get("e2e.rows_total").value == 6 * 48
    assert reg.get("e2e.epochs_total").value == 2


@pytest.mark.parametrize("overlap", [False, True], ids=["overlap_off", "overlap_on"])
def test_a_stopped_service_surfaces_in_next(world, overlap):
    svc = _service(world)
    svc.stop()  # a dead service: submit raises inside the producer
    pipe_in = tinput.TrainInputPipeline(svc, lambda: iter(world["payloads"]), batch_rows=48,
                                        n_steps=2, overlap=overlap, device="cpu")
    got, errors = _consume_in_thread(pipe_in)
    assert got == [] and len(errors) == 1 and isinstance(errors[0], RuntimeError)


@pytest.mark.parametrize("overlap", [False, True], ids=["overlap_off", "overlap_on"])
def test_a_service_failing_mid_stream_surfaces_in_next(world, overlap):
    """The service's loop fails on its third micro-batch: the requests
    behind it fail, and the trainer's next() raises within the bound."""
    svc = _service(world)
    dispatch, calls = svc.scheduler.dispatch, []

    def failing(batch):
        calls.append(1)
        if len(calls) >= 3:
            raise OSError("device lost")
        return dispatch(batch)

    svc.scheduler.dispatch = failing
    try:
        pipe_in = tinput.TrainInputPipeline(svc, lambda: iter(world["payloads"]),
                                            batch_rows=PAYLOAD_ROWS, n_steps=8,
                                            overlap=overlap, device="cpu")
        got, errors = _consume_in_thread(pipe_in)
    finally:
        svc.stop()
    assert len(got) <= 2 and len(errors) == 1
    err = errors[0]
    assert isinstance(err, OSError) or isinstance(err.__cause__, OSError), repr(err)


def test_an_early_stop_does_not_hang(world):
    """The trainer leaves after one batch: the prefetcher stops and the
    service still stops, both within the bound."""
    svc = _service(world)
    pipe_in = tinput.TrainInputPipeline(svc, lambda: iter(world["payloads"]),
                                        batch_rows=PAYLOAD_ROWS, n_steps=50, device="cpu")
    done = threading.Event()

    def run():
        for _ in pipe_in:
            break
        svc.stop()
        done.set()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=WAIT)
    assert done.is_set() and not t.is_alive()


def test_input_pipeline_defaults_to_the_card(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinput.TrainInputPipeline(None, [], batch_rows=4, n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dlrm_e2e.main(["--steps", "2", "--rows", "256", "--batch", "64"])


def _train_port(svc, world, overlap, steps=6):
    """DLRM weights after ``steps`` AdamW steps fed by ``svc``."""
    feed = train_dlrm_e2e.Feed(world["tcfg"], world["tstate"], world["payloads"],
                               PAYLOAD_ROWS, 0.0)
    ocfg = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, steps), weight_decay=0.0)
    report, model = train_dlrm_e2e.train(svc, feed, tdlrm.DLRMConfig(**MODEL), ocfg,
                                         steps=steps, batch=PAYLOAD_ROWS, overlap=overlap,
                                         seed=7)
    return report, [p.detach().clone() for p in leaves(model.params_tree())]


def test_trained_weights_bit_identical_across_overlap_and_cache(world):
    """6 steps wrap past one epoch of 4 payloads, so the cached run reads
    again: overlap off/on and cache cold/warm end in the same weights, bit
    for bit, and the warm run dispatches no micro-batch."""
    svc = _service(world)
    try:
        _, w_off = _train_port(svc, world, False)
        _, w_on = _train_port(svc, world, True)
    finally:
        svc.stop()
    cache = cc.ChunkCache(capacity_bytes=1 << 22)
    svc = _service(world, cache=cache)
    try:
        cold, w_cold = _train_port(svc, world, True)
        dispatched = cold["service_batches"]
        warm, w_warm = _train_port(svc, world, False)
    finally:
        svc.stop()
    assert warm["service_batches"] == dispatched  # every warm request hit
    assert cache.stats()["hits_total"] > 0
    for w in (w_on, w_cold, w_warm):
        assert len(w) == len(w_off)
        for a, b in zip(w, w_off):
            assert torch.equal(a, b)
    assert cold["e2e_counters"] == {"batches_total": 6, "rows_total": 6 * PAYLOAD_ROWS,
                                    "epochs_total": 2}


def test_losses_match_reference_run(world):
    """The reference's jitted train step fed by its service, against the
    port's fed by its own, from the same initial weights, at the lockstep
    tolerances of tests/test_torch_train.py: at every step the port's step
    on the reference's current weights and AdamW state gives its loss and
    grad_norm within rtol 1e-4; the port left to run on its own stays
    within 0.01 of the reference's loss curve."""
    steps = 6
    jcfg = jdlrm.DLRMConfig(**MODEL)
    jo = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-3, 2, steps), weight_decay=0.0)
    to = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, steps), weight_decay=0.0)
    jsvc = JService(world["jcfg"], world["jstate"], bucket_rows=(PAYLOAD_ROWS,)).start()
    try:
        jbatches = list(jinput.TrainInputPipeline(
            jsvc, lambda: iter(world["payloads"]), batch_rows=PAYLOAD_ROWS, n_steps=steps,
            overlap=False))
    finally:
        jsvc.stop()
    svc = _service(world)
    try:
        tbatches, _ = _port_batches(svc, world, True, batch_rows=PAYLOAD_ROWS, n_steps=steps)
    finally:
        svc.stop()

    params = jdlrm.init(jax.random.PRNGKey(7), jcfg)
    opt_state = jopt.adamw_init(params)
    j_step = jax.jit(jsteps.make_tabular_train_step(jdlrm.loss, jo))
    t_step = tsteps.make_tabular_train_step(tdlrm.loss, to)
    free = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    free_state = topt.adamw_init(free.params_tree())
    j_losses, free_losses = [], []
    for k in range(steps):
        model = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
        state = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, opt_state),
                                               device="cpu")
        tm = t_step(model, state, tbatches[k])
        params, opt_state, jm = j_step(params, opt_state, jbatches[k])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {k} {key}")
        j_losses.append(float(jm["loss"]))
        free_losses.append(float(t_step(free, free_state, tbatches[k])["loss"]))
    np.testing.assert_allclose(free_losses, j_losses, rtol=0, atol=0.01)


def test_launcher_runs_on_the_cpu(tmp_path):
    """The launcher end to end on the CPU: loop ①, the service with its
    cache, 100 steps over 13 epochs of 8 payloads, a checkpoint at step 100
    (after the lagged loss is drained), the stall split and a trace; the
    loss falls (main raises otherwise)."""
    trace = tmp_path / "trace.json"
    report = train_dlrm_e2e.main(["--device", "cpu", "--steps", "100", "--rows", "2048",
                                  "--batch", "256", "--ckpt-dir", str(tmp_path / "ck"),
                                  "--cache-mb", "8", "--trace", str(trace)])
    assert report["steps"] == 100 and report["device"] == "cpu"
    assert report["checkpoints"] == [100] and len(report["losses"]) == 100
    assert report["cache"]["hits_total"] > 0
    assert report["e2e_counters"]["epochs_total"] == 13
    assert trace.exists() and (tmp_path / "trace.metrics.json").exists()
    assert not obs.enabled()  # the process tracer is off again
    assert set(report["e2e_stall"]["fractions"]) == {"input_wait", "train_step"}
    assert set(report["service_stall"]["fractions"]) == {
        "queue_wait", "host_assembly", "device_dispatch", "vocab_merge"}
