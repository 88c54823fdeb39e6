"""The port's training side (repro_torch.train) against the JAX package's
(repro.train) on the same numpy inputs: the optimizers and schedules over
the same gradients, the tabular train step, the offline batch assembly
(``stream_batches``), the checkpoint format in both directions, and the
slice as a whole (Piper → DLRM, the reference's 256-row end-to-end test)
through both packages from the same weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import piper_dlrm as jcfg
from repro.core import pipeline as jP
from repro.core import vocab as jvocab
from repro.data import synth as jsynth
from repro.models import dlrm as jdlrm
from repro.train import checkpoint as jckpt
from repro.train import input_pipeline as jinput
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch.configs import piper_dlrm as tcfg
from repro_torch.core import pipeline as tP
from repro_torch.core import schema as tschema
from repro_torch.data import synth as tsynth
from repro_torch.models import dlrm as tdlrm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import input_pipeline as tinput
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train.tree import leaves, leaves_with_paths, tree_map

NARROW = jdlrm.DLRMConfig(vocab_range=101, embed_dim=16, bottom_mlp=(32, 16),
                          top_mlp=(32, 16, 1))


def _np_tree(seed, zero_row=True):
    """A small parameter-shaped tree of float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    tree = {
        "tables": rng.standard_normal((3, 5, 4)).astype(np.float32),
        "bottom": [{"w": rng.standard_normal((4, 6)).astype(np.float32),
                    "b": rng.standard_normal(6).astype(np.float32)}],
        "top": [{"w": rng.standard_normal((6, 1)).astype(np.float32),
                 "b": rng.standard_normal(1).astype(np.float32)}],
    }
    if zero_row:
        tree["tables"][1, 2] = 0  # a row with no gradient, as most table rows
    return tree


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)), tree)


def _assert_close(got_tree, want_tree, rtol, atol, what):
    for (path, g), w in zip(leaves_with_paths(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("schedule", [
    ("cosine", (1e-3, 3, 10)), ("cosine", (2e-3, 0, 5, 0.2)), ("constant", (3e-4,))])
def test_schedules_match_reference(schedule):
    """float32 arithmetic on the step: rtol 1e-6."""
    name, args = schedule
    j = getattr(jopt, f"{name}_schedule")(*args)
    t = getattr(topt, f"{name}_schedule")(*args)
    for step in range(12):
        np.testing.assert_allclose(float(t(torch.tensor(step, dtype=torch.int32))),
                                   float(j(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e9], ids=["clipped", "unclipped"])
def test_global_norm_and_clipping_match_reference(max_norm):
    """Per-leaf norms combined, against one sum of squares: rtol 1e-6. The
    clip scales the given tensors in place."""
    tree = _np_tree(1)
    want, want_norm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    t = _torch(tree)
    tables = t["tables"]
    got, got_norm = topt.clip_by_global_norm(t, max_norm)
    assert got is t and got["tables"] is tables
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(_torch(tree))),
                               float(jopt.global_norm(tree)), rtol=1e-6)
    _assert_close(got, want, 1e-6, 0, "clipped")


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_reference_over_three_steps(schedule):
    """The same numpy gradients each step; params, m, v, step, grad_norm and
    lr after each. Tolerance rtol 1e-5, atol 1e-7: float32 updates whose
    rounding differs by an ulp or two (fused multiply-adds); the gradients
    are far from zero, so no sign of an update can flip."""
    sched = (jopt.constant_schedule(1e-2), topt.constant_schedule(1e-2)) if schedule == \
        "constant" else (jopt.cosine_schedule(1e-2, 1, 3), topt.cosine_schedule(1e-2, 1, 3))
    jc = jopt.AdamWConfig(schedule=sched[0], max_grad_norm=2.0)
    tc = topt.AdamWConfig(schedule=sched[1], max_grad_norm=2.0)
    params = _np_tree(2, zero_row=False)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.adamw_init(jp)
    tp = _torch(params)
    ts = topt.adamw_init(tp)
    assert set(ts) == {"m", "v", "step"} and ts["step"].dtype == torch.int32
    for k in range(3):
        grads = _np_tree(10 + k)
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, jc)
        tp2, ts2, tm = topt.adamw_update(tp, _torch(grads), ts, tc)
        assert tp2 is tp and ts2 is ts  # in place
        _assert_close(tp, jp, 1e-5, 1e-7, f"step {k} params")
        _assert_close(ts["m"], js["m"], 1e-5, 1e-7, f"step {k} m")
        _assert_close(ts["v"], js["v"], 1e-5, 1e-7, f"step {k} v")
        assert int(ts["step"]) == int(js["step"]) == k + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_sgd_matches_reference_over_three_steps():
    params = _np_tree(3)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.sgd_init(jp)
    tp = _torch(params)
    ts = topt.sgd_init(tp)
    for k in range(3):
        grads = _np_tree(20 + k)
        jp, js, _ = jopt.sgd_update(jp, jax.tree.map(jnp.asarray, grads), js, lr=0.05)
        topt.sgd_update(tp, _torch(grads), ts, lr=0.05)
        _assert_close(tp, jp, 1e-6, 1e-7, f"step {k} params")
        _assert_close(ts["mom"], js["mom"], 1e-6, 1e-7, f"step {k} mom")
        assert int(ts["step"]) == k + 1


def test_adafactor_matches_reference_over_three_steps():
    """1-D, 2-D and 3-D leaves (factored second moment on the last two
    axes): rtol 1e-5, atol 1e-7, float32 means and square roots."""
    params = _np_tree(4)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adafactor_init(jp)
    tp = _torch(params)
    ts = topt.adafactor_init(tp)
    assert set(ts["v"]["tables"]) == {"vr", "vc"} and set(ts["v"]["top"][0]["b"]) == {"v"}
    for k in range(3):
        grads = _np_tree(30 + k)
        jp, js, _ = jopt.adafactor_update(jp, jax.tree.map(jnp.asarray, grads), js, lr=0.05)
        topt.adafactor_update(tp, _torch(grads), ts, lr=0.05)
        _assert_close(tp, jp, 1e-5, 1e-7, f"step {k} params")
        _assert_close(ts["v"], js["v"], 1e-5, 1e-7, f"step {k} v")


def _dlrm_batch(seed, cfg, rows=64):
    rng = np.random.default_rng(seed)
    return {
        "dense": np.log1p(rng.integers(0, 3000, (rows, cfg.n_dense))).astype(np.float32),
        "sparse": rng.integers(0, cfg.vocab_range, (rows, cfg.n_sparse)).astype(np.int32),
        "label": rng.integers(0, 2, rows).astype(np.int32),
    }


def test_tabular_train_step_matches_reference():
    """Three steps of ``make_tabular_train_step`` from the same weights on
    the same batches: loss, grad_norm and lr per step (rtol 1e-4: float32
    sums in another order, and AdamW's first update is sign(g)·lr, so a
    near-zero gradient of either sign moves a weight by lr), the step-1
    gradients within 1e-5 of each leaf's largest entry; the gradients are
    dropped after the step."""
    params = jdlrm.init(jax.random.PRNGKey(1), NARROW)
    model = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    jc = jopt.AdamWConfig()
    j_step = jax.jit(jsteps.make_tabular_train_step(jdlrm.loss, jc))
    t_step = tsteps.make_tabular_train_step(tdlrm.loss, topt.AdamWConfig())
    js = jopt.adamw_init(params)
    ts = topt.adamw_init(model.params_tree())
    first = _dlrm_batch(0, NARROW)
    _, want_grads = jax.value_and_grad(jdlrm.loss)(params, jax.tree.map(jnp.asarray, first))
    _, got_grads = tsteps.value_and_grad(tdlrm.loss, model,
                                         {k: torch.from_numpy(v) for k, v in first.items()})
    for (path, g), w in zip(leaves_with_paths(got_grads), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), path
    for k in range(3):
        batch = _dlrm_batch(k, NARROW)
        params, js, jm = j_step(params, js, jax.tree.map(jnp.asarray, batch))
        tm = t_step(model, ts, {kk: torch.from_numpy(v) for kk, v in batch.items()})
        assert set(tm) == {"loss", "grad_norm", "lr"}
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in tm.values())
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, err_msg=key)
        assert all(p.grad is None for p in leaves(model.params_tree()))
    assert int(ts["step"]) == 3


class _Done:
    def __init__(self, res):
        self._res = res

    def result(self):
        return self._res


class _EchoService:
    """Stands in for the stream service: each payload is its own result."""

    def submit(self, payload):
        return _Done(payload)


@pytest.mark.parametrize("batch_rows,n_steps", [(32, 12), (7, 5), (200, 3)])
def test_batch_assembly_matches_reference(batch_rows, n_steps):
    """Ragged source batches (0 to 100 valid rows, padding rows between),
    across epoch boundaries: the port's offline assembly (``stream_batches``)
    equals the reference ``TrainInputPipeline``'s (``overlap=False``) row
    for row."""
    rng = np.random.default_rng(batch_rows)
    payloads, outs = [], []
    for n in (7, 0, 30, 100, 3):
        p = {"label": rng.integers(0, 2, n).astype(np.int32),
             "dense": rng.standard_normal((n, 13)).astype(np.float32),
             "sparse": rng.integers(0, 500, (n, 26)).astype(np.int32)}
        payloads.append(p)
        pad = int(rng.integers(0, 4))
        valid = np.r_[np.ones(n, bool), np.zeros(pad, bool)]
        outs.append(tschema.ProcessedBatch(
            label=torch.from_numpy(np.r_[p["label"], np.full(pad, 9, np.int32)]),
            dense=torch.from_numpy(np.r_[p["dense"], np.full((pad, 13), -1, np.float32)]),
            sparse=torch.from_numpy(np.r_[p["sparse"], np.full((pad, 26), -1, np.int32)]),
            valid=torch.from_numpy(valid)))
    want = list(jinput.TrainInputPipeline(
        _EchoService(), payloads, batch_rows=batch_rows, n_steps=n_steps, overlap=False))
    for source in (outs, lambda: iter(outs)):
        got = list(tinput.stream_batches(source, batch_rows=batch_rows, n_steps=n_steps))
        assert len(got) == len(want) == n_steps
        for g, w in zip(got, want):
            assert set(g) == set(tinput.FIELDS)
            for k in tinput.FIELDS:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_batch_assembly_refuses_an_empty_source():
    empty = tschema.ProcessedBatch(*(torch.zeros((0,) + s, dtype=d) for s, d in (
        ((), torch.int32), ((13,), torch.float32), ((26,), torch.int32), ((), torch.bool))))
    for source in ([], [empty]):
        with pytest.raises(ValueError, match="no rows"):
            list(tinput.stream_batches(source, batch_rows=4, n_steps=1))
    with pytest.raises(ValueError, match="batch_rows"):
        tinput.stream_batches([], batch_rows=0, n_steps=1)


def _ckpt_trees(track_counts):
    """The same train state in both packages: DLRM params, AdamW state after
    one update, and a loop-① VocabState under extra."""
    params = jdlrm.init(jax.random.PRNGKey(2), NARROW)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), params)
    params, opt, _ = jopt.adamw_update(params, grads, jopt.adamw_init(params),
                                       jopt.AdamWConfig())
    rng = np.random.default_rng(3)
    state = jvocab.VocabState.init(26, 101, track_counts=track_counts)
    state = jvocab.update(state, jnp.asarray(rng.integers(0, 101, (50, 26)).astype(np.int32)),
                          jnp.ones(50, bool))
    jtree = {"params": params, "opt": opt, "extra": {"vocab": state}}
    fp, rs, cnt = (np.asarray(x) if x is not None else None
                   for x in (state.first_pos, state.rows_seen, state.counts))
    ttree = {
        "params": interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params),
                                                 device="cpu").params_tree(),
        "opt": interop.adamw_state_from_numpy(jax.tree.map(np.asarray, opt), device="cpu"),
        "extra": {"vocab": interop.vocab_state_from_numpy(fp, rs, cnt, device="cpu")},
    }
    return jtree, ttree


def _manifest(path):
    return json.loads((path / "MANIFEST.json").read_text())


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_checkpoint_restores_across_packages(tmp_path, track_counts):
    """Each package restores the other's checkpoint with equal values, and
    both write the same manifest (keys, files, shapes, dtypes) for the same
    train state."""
    jtree, ttree = _ckpt_trees(track_counts)
    for a, b in zip(leaves(interop.adamw_state_to_numpy(ttree["opt"])),
                    jax.tree.leaves(jtree["opt"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    tdir = tckpt.save(str(tmp_path / "port"), 7, ttree)
    jdir = jckpt.save(str(tmp_path / "ref"), 7, jtree)
    assert os.path.basename(tdir) == os.path.basename(jdir) == "step_00000007"
    tm, jm = _manifest(tmp_path / "port" / "step_00000007"), _manifest(
        tmp_path / "ref" / "step_00000007")
    assert tm == jm
    assert "extra/vocab/first_pos" in tm["leaves"] and "params/bottom/0/w" in tm["leaves"]
    assert ("extra/vocab/counts" in tm["leaves"]) == track_counts
    # the reference reads the port's checkpoint into its own trees
    back = jckpt.restore(str(tmp_path / "port"), 7, jax.eval_shape(lambda: jtree))
    assert isinstance(back["extra"]["vocab"], jvocab.VocabState)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port reads the reference's into its own
    got = tckpt.restore(str(tmp_path / "ref"), 7, ttree, device="cpu")
    assert set(got["extra"]["vocab"].__dataclass_fields__) >= {"first_pos", "rows_seen"}
    for (path, a), b in zip(leaves_with_paths(got), leaves(ttree)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b.detach()), path


def test_checkpoint_atomic_keep_latest_and_snapshot(tmp_path):
    """Atomic ``.tmp`` then rename; ``keep`` newest steps; ``latest_step``
    skips a manifest marked incomplete; the async snapshot is taken before
    in-place training updates go on; a failed write raises from ``wait``."""
    root = str(tmp_path)
    x = torch.zeros(4)
    acp = tckpt.AsyncCheckpointer(root, keep=2)
    for step in (1, 2, 3):
        acp.save_async(step, {"x": x})
        x.add_(100)  # training goes on in place
    acp.wait()
    assert not any(p.endswith(".tmp") for p in os.listdir(root))
    assert tckpt.list_steps(root) == [2, 3]
    restored = tckpt.restore(root, 3, {"x": x}, device="cpu")
    assert torch.equal(restored["x"], torch.full((4,), 200.0))
    tckpt.save(root, 4, {"x": x})
    man = tmp_path / "step_00000004" / "MANIFEST.json"
    data = json.loads(man.read_text())
    data["complete"] = False
    man.write_text(json.dumps(data))
    assert tckpt.latest_step(root) == 3
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(root, 3, {"y": x}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(root, 3, {"x": torch.zeros(5)}, device="cpu")
    (tmp_path / "blocked").write_text("not a directory")
    bad = tckpt.AsyncCheckpointer(str(tmp_path / "blocked"))
    bad.save_async(1, {"x": x})
    with pytest.raises(OSError):
        bad.wait()


def test_piper_to_dlrm_training_matches_reference():
    """The reference's end-to-end test (raw UTF-8 → Piper's two loops →
    DLRM, SMOKE at full width, the first chunk's 237 valid rows of 256, 30
    AdamW steps on that one batch) through both packages from the same
    weights.

    Piper's batches agree. At every step the port's train step runs on the
    reference's current weights and AdamW state: its loss and grad_norm
    agree within rtol 1e-4 (float32 sums in another order; measured up to
    2.5e-5, on grad_norm late in training when the gradient is small). Left
    to run on its own from the same initial weights, the port's loss curve
    stays within 0.01 of the reference's (measured: at most 3.1e-3) and
    both fall. The free-running curves are held only that loosely because
    AdamW moves every weight by about sign(g)·lr, also where the gradient
    is rounding noise, so the two trajectories part slowly."""
    cfg = jcfg.SMOKE
    buf, _ = jsynth.make_dataset(jsynth.SynthConfig(schema=cfg.pipeline.schema, rows=256,
                                                    seed=0, sparse_pool=128))
    jpipe = jP.PiperPipeline(jP.PipelineConfig(schema=cfg.pipeline.schema,
                                               max_rows_per_chunk=512))
    proc = list(jpipe.run_stream(lambda: jsynth.chunk_stream(buf, 1 << 16)))[0]
    v = np.asarray(proc.valid)
    jbatch = {k: jnp.asarray(np.asarray(getattr(proc, k))[v])
              for k in ("dense", "sparse", "label")}

    tbuf, _ = tsynth.make_dataset(tsynth.SynthConfig(schema=tcfg.SMOKE.schema, rows=256,
                                                     seed=0, sparse_pool=128))
    np.testing.assert_array_equal(tbuf, buf)
    tpipe = tP.PiperPipeline(tcfg.SMOKE.pipeline_config(device="cpu", max_rows_per_chunk=512))
    outs = list(tpipe.run_stream(lambda: tsynth.chunk_stream(tbuf, 1 << 16)))
    # the reference trains on the first chunk's valid rows, so every batch is those rows
    batches = list(tinput.stream_batches(outs[:1], batch_rows=int(v.sum()), n_steps=30))
    # Piper's own tolerance: dense at rtol 1e-6, the rest exact
    for key in ("sparse", "label"):
        np.testing.assert_array_equal(batches[0][key].numpy(), np.asarray(jbatch[key]))
    np.testing.assert_allclose(batches[0]["dense"].numpy(), np.asarray(jbatch["dense"]),
                               rtol=1e-6, atol=0)

    params = jdlrm.init(jax.random.PRNGKey(0), cfg.model)
    jc = jopt.AdamWConfig(schedule=jopt.constant_schedule(1e-3), weight_decay=0.0)
    tc = topt.AdamWConfig(schedule=topt.constant_schedule(1e-3), weight_decay=0.0)
    t_step = tsteps.make_tabular_train_step(tdlrm.loss, tc)
    free = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    free_state = topt.adamw_init(free.params_tree())
    opt_state = jopt.adamw_init(params)
    j_step = jax.jit(jsteps.make_tabular_train_step(jdlrm.loss, jc))
    j_losses, free_losses = [], []
    for k in range(30):
        # the port's step on the reference's current weights and state
        model = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
        state = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, opt_state),
                                               device="cpu")
        tm = t_step(model, state, batches[k])
        params, opt_state, jm = j_step(params, opt_state, jbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {k} {key}")
        j_losses.append(float(jm["loss"]))
        free_losses.append(float(t_step(free, free_state, batches[k])["loss"]))
    np.testing.assert_allclose(free_losses, j_losses, rtol=0, atol=0.01)
    assert j_losses[-1] < j_losses[0] and free_losses[-1] < free_losses[0]
