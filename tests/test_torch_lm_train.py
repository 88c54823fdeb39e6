"""LM training in the port against the JAX package: ``chunked_ce``,
``LM.loss`` and its gradients, remat, ``make_train_step`` with
microbatches, the fault-tolerant ``Trainer`` (and checkpoints that cross
between the two packages' trainers), the configs of the dense decoders,
``launch/train.py``'s Piper tokens and its ``main``.

The same inputs, made with numpy (the weights by the JAX package's
``init``, carried over with ``interop``), go through both packages.
Tolerances, each beside the gap measured on this CPU:
  * ``chunked_ce`` in float32: loss 1e-5 relative (measured 8e-8), each
    gradient 1e-5 of its largest entry (measured 5e-7);
  * ``LM.loss`` at gemma-2b SMOKE in bf16 compute: loss 1e-3 relative
    (measured 3.2e-5 chunked, 3.9e-5 einsum), every parameter's gradient
    |Δ|₂ ≤ 5e-2·|g|₂ (measured at most 1.86e-2): XLA and torch round
    the bf16 activations at other points;
  * one AdamW step (lr 1e-3) from the same weights and batch: loss and
    grad_norm 1e-3 relative (measured 2.2e-6 and 4.7e-5); at most 2% of
    a leaf's elements more than lr from the reference's (measured at most
    0.57%, in blocks/0/attn/wq). AdamW's first step is about lr·sign(g),
    so an element of the two packages is about 0 or 2·lr apart, the
    latter where a gradient within bf16 rounding of 0 takes the other
    sign: that fraction is the weight check (with the per-leaf gradient
    tests above), as no gap can exceed 2·lr;
  * trainer losses continued across packages: 1e-3 relative.
The port against itself (remat on and off, resume against an
uninterrupted run, rollback) is held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import loader as jloader
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import shapes as tshapes
from repro_torch.data import loader as tloader
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train import trainer as ttrainer
from repro_torch.train.tree import leaves, tree_map

CE_F32_REL = 1e-5
LOSS_BF16_REL = 1e-3
GRAD_BF16_REL_L2 = 5e-2
STEP_LR = 1e-3
SIGN_FLIP_FRAC = 0.02
TRAINER_LOSS_REL = 1e-3


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _grads_numpy(params):
    return interop.lm_params_to_numpy(tree_map(lambda p: p.grad, params))


@pytest.fixture(scope="module")
def gemma():
    """gemma-2b SMOKE in both packages, the JAX init's weights."""
    jcfg, tcfg = jconfigs.get_smoke("gemma-2b"), tconfigs.get_smoke("gemma-2b")
    jparams = jlm.LM(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 48)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tree=tree, tokens=tokens)


# --------------------------------------------------------------------- #
# chunked_ce and LM.loss
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seq,block", [(700, 256), (512, 512), (37, 512)],
                         ids=["padded", "whole_blocks", "one_short_block"])
def test_chunked_ce_and_its_gradient_match_the_reference(seq, block):
    """float32, a masked weight, and (but for whole_blocks) a sequence that
    is not a multiple of the block (the padding path)."""
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 97)) * 0.3).astype(np.float32)
    t = rng.integers(0, 97, (2, seq)).astype(np.int32)
    wt = (rng.random((2, seq)) > 0.3).astype(np.float32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jlm.chunked_ce(a, b, jnp.asarray(t), jnp.asarray(wt), block=block),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tl = tlm.chunked_ce(tx, tw, torch.from_numpy(t), torch.from_numpy(wt), block=block)
    tl.backward()
    assert abs(float(tl) / float(jl) - 1) <= CE_F32_REL
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= CE_F32_REL * np.abs(want).max()
    with torch.no_grad():  # no checkpoint outside autograd: the same value
        again = tlm.chunked_ce(tx, tw, torch.from_numpy(t), torch.from_numpy(wt), block=block)
    assert torch.equal(again, tl.detach())


@pytest.mark.parametrize("impl", ["chunked", "einsum"])
def test_lm_loss_and_every_gradient_match_the_reference(impl, gemma):
    """gemma-2b SMOKE, bf16 compute, loss and the gradient of every
    parameter against jax.value_and_grad of the reference's LM.loss."""
    jmodel = jlm.LM(gemma["jcfg"], attn_impl=impl)
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss(p, jnp.asarray(gemma["tokens"])))(
        gemma["jparams"])
    model = tlm.LM(gemma["tcfg"], attn_impl=impl, ce_block=32, device="cpu")
    params = tsteps.trainable(interop.lm_params_from_numpy(gemma["tree"], gemma["tcfg"],
                                                           device="cpu"))
    loss = model.loss(params, torch.from_numpy(gemma["tokens"]))
    loss.backward()
    assert abs(float(loss) / float(jl) - 1) <= LOSS_BF16_REL
    got = _grads_numpy(params)
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, want), g in zip(paths, jax.tree.leaves(got)):
        assert _rel_l2(g, want) <= GRAD_BF16_REL_L2, jax.tree_util.keystr(path)


def test_remat_on_and_off_give_equal_losses_and_gradients(gemma):
    """Remat recomputes the same forward: equal bits, and with remat the
    backward runs each superblock's forward again."""
    out = {}
    for remat in (True, False):
        model = tlm.LM(gemma["tcfg"], remat=remat, ce_block=16, device="cpu")
        params = tsteps.trainable(interop.lm_params_from_numpy(gemma["tree"], gemma["tcfg"],
                                                               device="cpu"))
        calls = []
        body = model._superblock_body
        model._superblock_body = lambda *a: calls.append(1) or body(*a)
        loss = model.loss(params, torch.from_numpy(gemma["tokens"]))
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in leaves(params)], len(calls))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    n = gemma["tcfg"].n_superblocks
    assert (out[True][2], out[False][2]) == (2 * n, n)


def test_flash_route_still_raises_in_the_backward(gemma):
    model = tlm.LM(gemma["tcfg"], attn_impl="flash", device="cpu")
    params = tsteps.trainable(model.init(torch.Generator().manual_seed(0)))
    loss = model.loss(params, torch.from_numpy(gemma["tokens"]))
    with pytest.raises(RuntimeError, match="flash_attention has no gradient"):
        loss.backward()


# --------------------------------------------------------------------- #
# make_train_step
# --------------------------------------------------------------------- #
def _opt_cfgs():
    return (jopt.AdamWConfig(schedule=jopt.constant_schedule(STEP_LR)),
            topt.AdamWConfig(schedule=topt.constant_schedule(STEP_LR)))


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_train_step_matches_the_reference(microbatches, gemma):
    """One step from the same weights and batch of 8 × 32 tokens."""
    jcfg, tcfg = gemma["jcfg"], gemma["tcfg"]
    jo, to = _opt_cfgs()
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (8, 32)).astype(np.int32)
    jmodel = jlm.LM(jcfg)
    jp = gemma["jparams"]
    jp1, jst, jm = jsteps.make_train_step(jmodel, jo, microbatches)(
        jp, jopt.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    model = tlm.LM(tcfg, device="cpu")
    params = interop.lm_params_from_numpy(gemma["tree"], tcfg, device="cpu")
    opt = topt.adamw_init(params)
    metrics = tsteps.make_train_step(model, to, microbatches)(
        params, opt, {"tokens": torch.from_numpy(tokens)})
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[key]) / float(jm[key]) - 1) <= LOSS_BF16_REL, key
    assert int(opt["step"]) == int(jst["step"]) == 1
    assert all(p.grad is None for p in leaves(params))  # dropped before the return
    got = jax.tree.leaves(interop.lm_params_to_numpy(params))
    for want, g in zip(jax.tree.leaves(jp1), got):
        want = np.asarray(want)
        assert (np.abs(g - want) > STEP_LR).mean() <= SIGN_FLIP_FRAC


def test_microbatch_grad_accum_equivalence():
    """mb=1 against mb=4 in the port (tests/test_train.py's check and
    bounds): the loss is a mean of equal-sized groups' means."""
    cfg = tconfigs.get_smoke("minitron-8b")
    model = tlm.LM(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = topt.AdamWConfig(schedule=topt.constant_schedule(1e-3))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))}
    out = {}
    for mb in (1, 4):
        p = tree_map(lambda t: t.clone(), params)
        m = tsteps.make_train_step(model, opt_cfg, microbatches=mb)(p, topt.adamw_init(p), batch)
        out[mb] = (p, m)
    assert abs(float(out[1][1]["loss"]) - float(out[4][1]["loss"])) < 2e-2
    for a, b in zip(leaves(out[1][0]), leaves(out[4][0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=3e-3)


def test_train_step_refuses_what_it_does_not_take():
    cfg = tconfigs.get_smoke("gemma-2b")
    model = tlm.LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    step = tsteps.make_train_step(model, topt.AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, topt.adamw_init(params), {"tokens": torch.zeros((4, 8), dtype=torch.int32)})
    with pytest.raises(ValueError, match="frames"):
        step(params, topt.adamw_init(params), {"tokens": torch.zeros((3, 8), dtype=torch.int32),
                                               "frames": torch.zeros((3, 4, cfg.d_model))})
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.make_train_step(model, topt.AdamWConfig(), microbatches=0)


# --------------------------------------------------------------------- #
# the Trainer
# --------------------------------------------------------------------- #
def _tiny_model(remat=False):
    cfg = tconfigs.get_smoke("minitron-8b")
    return cfg, tlm.LM(cfg, remat=remat, device="cpu")


def _trainer(root, cfg, model, total_steps, ckpt_every=50, seed=0):
    batch_fn = tloader.TokenBatches(cfg.vocab_size, batch=4, seq=32, seed=seed)
    tcfg = ttrainer.TrainerConfig(total_steps=total_steps, ckpt_dir=str(root / "ckpt"),
                                  ckpt_every=ckpt_every, handle_signals=False)
    opt_cfg = topt.AdamWConfig(schedule=topt.constant_schedule(3e-3), weight_decay=0.0)
    return ttrainer.Trainer(model, opt_cfg, tcfg, batch_fn)


def _same_params(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _loss_decreases(tmp_path):
    cfg, model = _tiny_model()
    out = _trainer(tmp_path, cfg, model, total_steps=20).run(0)
    assert out["final_step"] == 20 and len(out["losses"]) == 20
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def _resume_bitexact(tmp_path):
    """Interrupted and resumed == uninterrupted (same batches, same final
    parameters and AdamW state, bit for bit): the fault-tolerance contract.
    Remat on, as the launcher trains."""
    cfg, model = _tiny_model(remat=True)
    full = _trainer(tmp_path / "full", cfg, model, total_steps=10, ckpt_every=10).run(0)
    _trainer(tmp_path / "resumed", cfg, model, total_steps=5, ckpt_every=5).run(0)
    out = _trainer(tmp_path / "resumed", cfg, model, total_steps=10, ckpt_every=5).run(0)
    assert out["final_step"] == 10 and out["losses"] == full["losses"][5:]
    assert _same_params(out["params"], full["params"])
    assert _same_params(out["opt_state"], full["opt_state"])


def _preemption_saves_and_resumes(tmp_path):
    cfg, model = _tiny_model()
    t = _trainer(tmp_path, cfg, model, total_steps=100, ckpt_every=1000)
    orig, calls = t.batch_fn, {"n": 0}

    def preempting_batch(step):
        calls["n"] += 1
        if calls["n"] == 4:
            t.request_preemption()  # the SIGTERM handler's flag
        return orig(step)

    t.batch_fn = preempting_batch
    out = t.run(0)
    assert out["preempted"] and out["final_step"] < 100
    assert tckpt.latest_step(t.cfg.ckpt_dir) == out["final_step"]
    out2 = _trainer(tmp_path, cfg, model, total_steps=out["final_step"] + 3).run(0)
    assert out2["final_step"] == out["final_step"] + 3


def _straggler_detection(tmp_path):
    cfg, model = _tiny_model()
    import time

    t = _trainer(tmp_path, cfg, model, total_steps=12)
    seen = []
    t.straggler_callback = lambda step, dt: seen.append(step)
    orig, calls = t.batch_fn, []

    def slow_batch(step):
        calls.append(time.perf_counter())
        if step == 8:
            # a synthetic straggler, well past straggler_factor times any
            # step so far (a loaded CPU slows every step alike)
            time.sleep(max(1.0, 10 * max(b - a for a, b in zip(calls[1:-1], calls[2:]))))
        return orig(step)

    t.batch_fn = slow_batch
    out = t.run(0)
    assert out["stragglers"] >= 1 and 8 in seen


def _nonfinite_loss_rolls_back(tmp_path):
    """A non-finite loss at step 7 (read one step late, after step 8 ran)
    restores the step-5 checkpoint and replays: the run ends where an
    undisturbed one does, bit for bit."""
    cfg, model = _tiny_model()
    clean = _trainer(tmp_path / "clean", cfg, model, total_steps=10, ckpt_every=5).run(0)
    t = _trainer(tmp_path / "spiked", cfg, model, total_steps=10, ckpt_every=5)
    step_fn, calls = t.train_step, {"n": 0}

    def spiking(params, opt, batch):
        metrics = step_fn(params, opt, batch)
        calls["n"] += 1
        if calls["n"] == 8:  # step 7, the first time
            metrics["loss"] = torch.tensor(float("nan"))
        return metrics

    t.train_step = spiking
    out = t.run(0)
    assert out["rollbacks"] == 1 and out["final_step"] == 10 and calls["n"] == 9 + 5
    assert out["losses"] == clean["losses"][:7] + clean["losses"][5:]  # 5 and 6 read twice
    assert _same_params(out["params"], clean["params"])
    with pytest.raises(FloatingPointError, match="step 0"):  # no checkpoint to roll back to
        t = _trainer(tmp_path / "early", cfg, model, total_steps=4)
        t.train_step = lambda p, o, b: dict(step_fn(p, o, b), loss=torch.tensor(float("inf")))
        t.run(0)


def _extra_state_is_checkpointed(tmp_path):
    """extra_state (here Piper's VocabState) is written beside the train
    state at every save, as the device held it then."""
    from repro_torch.core import vocab as tvocab

    cfg, model = _tiny_model()
    state = tvocab.VocabState.init(3, 7, track_counts=True, device="cpu")
    state.first_pos[1, 2] = 5
    t = _trainer(tmp_path, cfg, model, total_steps=2, ckpt_every=1)
    t.extra_state = {"vocab": state}
    t.run(0)
    assert tckpt.list_steps(t.cfg.ckpt_dir) == [1, 2]
    back = tckpt.restore(t.cfg.ckpt_dir, 2, {"extra": t.extra_state}, device="cpu")["extra"]
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(t.extra_state)))


def _spans_with_the_tracer_on(tmp_path):
    """With the process tracer on, each save is a ``train/checkpoint`` span
    (labelled with its step), the end of the run ``train/checkpoint_wait``,
    and each step's update ``train/adamw`` around its ``train/clip``; with
    it off the Trainer records nothing."""
    from repro_torch import obs

    cfg, model = _tiny_model()
    tracer = obs.tracer()
    assert not obs.enabled()
    tracer.reset()
    _trainer(tmp_path / "off", cfg, model, total_steps=2, ckpt_every=1).run(0)
    assert tracer.events() == []
    obs.enable()
    try:
        _trainer(tmp_path / "on", cfg, model, total_steps=2, ckpt_every=1).run(0)
    finally:
        obs.disable()
    events = tracer.events()
    tracer.reset()
    names = [e["name"] for e in events]
    assert names.count("train/adamw") == names.count("train/clip") == 2
    assert names.count("train/checkpoint_wait") == 1
    assert [e["args"]["step"] for e in events if e["name"] == "train/checkpoint"] == [1, 2]
    for adamw, clip in zip((e for e in events if e["name"] == "train/adamw"),
                           (e for e in events if e["name"] == "train/clip")):
        assert adamw["ts"] <= clip["ts"] and clip["ts"] + clip["dur"] <= adamw["ts"] + adamw["dur"]


@pytest.mark.parametrize("contract", [_loss_decreases, _resume_bitexact,
                                      _preemption_saves_and_resumes, _straggler_detection,
                                      _nonfinite_loss_rolls_back, _extra_state_is_checkpointed,
                                      _spans_with_the_tracer_on],
                         ids=lambda f: f.__name__.strip("_"))
def test_trainer_contract(contract, tmp_path):
    """tests/test_train.py's contracts of the reference's Trainer, and the
    loss-spike guard, on the port's Trainer (minitron-8b SMOKE)."""
    contract(tmp_path)


def test_trainer_refuses_a_mesh():
    """A mesh that is no DeviceMesh, or shardings without a mesh, raise
    ValueError (the sharded trainer itself: tests/test_torch_ep.py)."""
    cfg, model = _tiny_model()
    with pytest.raises(ValueError, match="mesh must be a DeviceMesh"):
        ttrainer.Trainer(model, topt.AdamWConfig(), ttrainer.TrainerConfig(), lambda s: {},
                         mesh=object())
    with pytest.raises(ValueError, match="shardings without a mesh"):
        ttrainer.Trainer(model, topt.AdamWConfig(), ttrainer.TrainerConfig(), lambda s: {},
                         shardings=(None, None, None))


def _jax_trainer(root, total_steps, ckpt_every):
    cfg = jconfigs.get_smoke("minitron-8b")
    tcfg = jtrainer.TrainerConfig(total_steps=total_steps, ckpt_dir=str(root / "ckpt"),
                                  ckpt_every=ckpt_every, handle_signals=False)
    opt_cfg = jopt.AdamWConfig(schedule=jopt.constant_schedule(3e-3), weight_decay=0.0)
    return jtrainer.Trainer(jlm.LM(cfg, remat=False), opt_cfg, tcfg,
                            jloader.TokenBatches(cfg.vocab_size, batch=4, seq=32, seed=0))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(first, tmp_path):
    """Two steps in one package's Trainer, a checkpoint, two more in the
    other's: the last two losses follow an uninterrupted run of the first
    package, and the resumed run's checkpoint restores in the first."""
    cfg, model = _tiny_model()
    root = tmp_path / "shared"
    if first == "jax":
        full = _jax_trainer(tmp_path / "full", 4, 4).run(jax.random.PRNGKey(0))["losses"]
        _jax_trainer(root, 2, 2).run(jax.random.PRNGKey(0))
        out = _trainer(root, cfg, model, total_steps=4, ckpt_every=2).run(0)
    else:
        full = _trainer(tmp_path / "full", cfg, model, total_steps=4, ckpt_every=4).run(0)
        full = full["losses"]
        _trainer(root, cfg, model, total_steps=2, ckpt_every=2).run(0)
        out = _jax_trainer(root, 4, 2).run(jax.random.PRNGKey(0))
    assert out["final_step"] == 4 and len(out["losses"]) == 2
    for got, want in zip(out["losses"], full[2:]):
        assert abs(got / want - 1) <= TRAINER_LOSS_REL
    # the resumed run's step-4 checkpoint, read back by the first package
    if first == "jax":
        skeleton = jax.eval_shape(jlm.LM(jconfigs.get_smoke("minitron-8b")).init,
                                  jax.random.PRNGKey(0))
        back = jckpt.restore(str(root / "ckpt"), 4, {"params": skeleton})["params"]
        want = interop.lm_params_to_numpy(out["params"])
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, jax.tree.map(np.asarray, back),
                                                want)))
    else:
        like = interop.lm_train_state_like(cfg)
        back = tckpt.restore(str(root / "ckpt"), 4, like, device="cpu")
        params, opt = interop.lm_train_state_from_numpy(back, cfg, device="cpu")
        want = jax.tree.map(np.asarray, out["params"])
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, want,
                                                interop.lm_params_to_numpy(params))))
        assert int(opt["step"]) == 4


def test_adamw_state_round_trips(gemma):
    tcfg = gemma["tcfg"]
    params = interop.lm_params_from_numpy(gemma["tree"], tcfg, device="cpu")
    opt = topt.adamw_init(params)
    tsteps.make_train_step(tlm.LM(tcfg, device="cpu"), topt.AdamWConfig())(
        params, opt, {"tokens": torch.from_numpy(gemma["tokens"])})
    tree = interop.lm_adamw_state_to_numpy(opt)
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 1
    back = interop.lm_adamw_state_from_numpy(tree, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(opt)))
    like = interop.lm_train_state_like(tcfg)
    shapes = [tuple(x.shape) for x in jax.tree.leaves(
        interop.lm_train_state_to_numpy(params, opt))]
    assert shapes == [tuple(t.shape) for t in leaves(like)]


# --------------------------------------------------------------------- #
# configs, shapes, build_model and the launcher
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["gemma-2b", "minitron-8b", "gemma-7b",
                                  "command-r-plus-104b"])
def test_dense_configs_match_the_reference(arch):
    """Field by field, CONFIG and SMOKE, and the parameter counts (the full
    ones counted on the meta device)."""
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()


def test_shapes_match_the_reference():
    from repro.configs import shapes as jshapes

    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in tconfigs.ARCH_IDS:
        for name, shape in tshapes.SHAPES.items():
            assert tshapes.applicable(tconfigs.get(arch), shape) == \
                jshapes.applicable(jconfigs.get(arch), jshapes.SHAPES[name])


def test_build_model():
    cfg = tconfigs.get_smoke("gemma-2b")
    model = tspecs.build_model(cfg, attn_impl="einsum", remat=False, attn_block_k=64,
                               ce_block=128, device="cpu")
    assert (model.remat, model.attn_impl, model.attn_block_k, model.ce_block) == \
        (False, "einsum", 64, 128)
    assert tspecs.build_model(cfg, device="cpu").remat is True
    audio = tconfigs.get_smoke("whisper-small")
    assert isinstance(tspecs.build_model(audio, device="cpu"), tlm.EncDec)
    assert isinstance(tspecs.build_model(dataclasses.replace(audio, family="vlm"),
                                         device="cpu"), tlm.LM)


def test_preprocess_tokens_match_the_reference():
    want = jlaunch.preprocess_tokens(700, 512)
    got = tlaunch.preprocess_tokens(700, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape == (700, 26)
    np.testing.assert_array_equal(got, want)


def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    out = tlaunch.main(["--device", "cpu", "--steps", "3", "--rows", "300",
                        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert tckpt.list_steps(str(tmp_path / "ckpt")) == [2, 3]
    assert "done: step=3" in capsys.readouterr().out
