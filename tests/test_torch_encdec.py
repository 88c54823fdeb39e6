"""The encoder-decoder in the port against the JAX package: whisper-small
at its SMOKE config (the config and parameter count, ``EncDec.encode``,
``forward``, ``loss`` and its gradients, the prefill and serve steps over
filled context caches, one AdamW step with ``frames`` in the batch,
``interop`` both ways for the parameters and a decode state with
``ctx_kv``), the flash route's choice by shape at whisper's ragged frame
count, ``build_model`` and the launchers.

Inputs and weights are made with numpy (the weights by the JAX package's
``EncDec.init``, carried over with ``interop``; the frames as the
reference's launcher makes them, normal · 0.1) and go through both
packages. Tolerances, the ones earlier slices set, each beside the gap
measured on this CPU:
  * float32 compute: 1e-5 of the largest value (measured at most 7.5e-7);
  * bf16 compute: 4e-2 of the largest value (tests/test_torch_lm.py's
    BF16_REL; measured at most 9.0e-3);
  * ``EncDec.loss`` in bf16: loss 1e-3 relative, every gradient
    |Δ|₂ ≤ 5e-2·|g|₂ (tests/test_torch_lm_train.py's; measured 1.3e-4 and
    at most 1.8e-2);
  * one AdamW step (lr 1e-3): loss and grad_norm 1e-3 relative (measured
    6.8e-5 and 5.2e-4), at most 2% of a leaf's elements more than lr from
    the reference's (measured at most 0.78%);
  * integers (parameter counts, shapes) exact, parameter trees bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train.tree import leaves, tree_map

ARCH = "whisper-small"
F32_REL = 1e-5
BF16_REL = 4e-2
LOSS_BF16_REL = 1e-3
GRAD_BF16_REL_L2 = 5e-2
STEP_LR = 1e-3
SIGN_FLIP_FRAC = 0.02
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= rel, gap


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _frames(rng, batch, cfg):
    """The reference launcher's stub frames: normal · 0.1, float32."""
    return rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def whisper():
    """whisper-small SMOKE in both packages: weights, tokens, frames."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jmodel = jlm.EncDec(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(6)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tparams=interop.lm_params_from_numpy(tree, tcfg, device="cpu"),
                tokens=rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32),
                frames=_frames(rng, 2, tcfg))


# --------------------------------------------------------------------- #
# config, parameters
# --------------------------------------------------------------------- #
def test_config_and_param_count_match_the_reference():
    """CONFIG and SMOKE equal as dataclasses; the parameter counts, the
    encoder's included, equal (the full config's on the meta device)."""
    for name in ("get", "get_smoke"):
        j, t = getattr(jconfigs, name)(ARCH), getattr(tconfigs, name)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()
    assert tconfigs.get(ARCH).param_count() == 279_092_736
    assert ARCH in tconfigs.ARCH_IDS


def test_params_round_trip_both_ways(whisper):
    """The reference's tree (with ``encoder``) → the port → numpy is the
    same tree; the port's own init → numpy → the port is the same
    parameters, and so is the trainer's checkpoint tree; a wrong encoder
    leaf raises."""
    back = interop.lm_params_to_numpy(whisper["tparams"])
    assert jax.tree.structure(back) == jax.tree.structure(whisper["tree"])
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, whisper["tree"], back)))
    tcfg = whisper["tcfg"]
    own = tlm.EncDec(tcfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert len(own["encoder"]["blocks"]) == tcfg.n_encoder_superblocks
    assert tuple(own["encoder"]["pos_embed"].shape) == (tcfg.encoder_frames, tcfg.d_model)
    again = interop.lm_params_from_numpy(interop.lm_params_to_numpy(own), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(own), leaves(again)))
    opt = topt.adamw_init(own)
    state = interop.lm_train_state_to_numpy(own, opt)
    like = interop.lm_train_state_like(tcfg)
    assert [tuple(t.shape) for t in leaves(like)] == [a.shape for a in leaves(state)]
    params, _ = interop.lm_train_state_from_numpy(state, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(own), leaves(params)))
    bad = dict(whisper["tree"], encoder=dict(whisper["tree"]["encoder"],
                                             pos_embed=whisper["tree"]["encoder"]["pos_embed"][1:]))
    with pytest.raises(ValueError, match="encoder.pos_embed"):
        interop.lm_params_from_numpy(bad, tcfg, device="cpu")


# --------------------------------------------------------------------- #
# encode, forward, loss
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_and_forward_match_the_reference(dtype, whisper):
    """EncDec.encode (frames + pos_embed, the bidirectional encoder, its
    final norm) and EncDec.forward against the reference's: float32 on the
    chunked route, bf16 on the flash route (every layer the kernel takes
    here: 32 frames, 24 tokens; the plain mha on the CPU)."""
    jdt, tdt = DTYPES[dtype]
    jm = whisper["jmodel"]
    frames, tokens = jnp.asarray(whisper["frames"]), jnp.asarray(whisper["tokens"])
    want_enc = jax.jit(lambda p, f: jm.encode(p, f, compute_dtype=jdt))(whisper["jparams"],
                                                                         frames)
    want, _ = jax.jit(lambda p, t, e: jm.decoder.forward(p, t, context=e, compute_dtype=jdt))(
        whisper["jparams"], tokens, want_enc)
    model = tlm.EncDec(whisper["tcfg"], attn_impl="chunked" if dtype == "f32" else "flash",
                       device="cpu")
    enc = model.encode(whisper["tparams"], torch.from_numpy(whisper["frames"]), tdt)
    assert enc.dtype == tdt
    _close(enc, want_enc, F32_REL if dtype == "f32" else BF16_REL)
    got = model.forward(whisper["tparams"], torch.from_numpy(whisper["tokens"]),
                        torch.from_numpy(whisper["frames"]), tdt)
    _close(got, want, F32_REL if dtype == "f32" else BF16_REL)


def test_loss_and_every_gradient_match_the_reference(whisper):
    """EncDec.loss (bf16, no auxiliary term, chunked_ce's default block)
    and the gradient of every parameter, the encoder's included, against
    jax.value_and_grad of the reference's."""
    jm = whisper["jmodel"]
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t, f: jm.loss(p, t, f)))(
        whisper["jparams"], jnp.asarray(whisper["tokens"]), jnp.asarray(whisper["frames"]))
    params = tsteps.trainable(interop.lm_params_from_numpy(whisper["tree"], whisper["tcfg"],
                                                           device="cpu"))
    loss = tlm.EncDec(whisper["tcfg"], ce_block=8, device="cpu").loss(
        params, torch.from_numpy(whisper["tokens"]), torch.from_numpy(whisper["frames"]))
    loss.backward()
    assert abs(float(loss.detach()) / float(jl) - 1) <= LOSS_BF16_REL
    got = interop.lm_params_to_numpy(tree_map(lambda p: p.grad, params))
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, want), g in zip(paths, jax.tree.leaves(got)):
        assert _rel_l2(g, want) <= GRAD_BF16_REL_L2, jax.tree_util.keystr(path)


def test_remat_gives_equal_losses_and_gradients(whisper):
    """Remat on and off (the encoder's and the decoder's superblocks)
    compute the same bits."""
    out = []
    for remat in (True, False):
        params = tsteps.trainable(tree_map(lambda t: t.clone(), whisper["tparams"]))
        loss = tlm.EncDec(whisper["tcfg"], remat=remat, device="cpu").loss(
            params, torch.from_numpy(whisper["tokens"]), torch.from_numpy(whisper["frames"]))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in leaves(params)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def test_prefill_and_serve_steps_match_the_reference(whisper):
    """make_prefill_step (encode, then the decoder's last position) in bf16;
    then the encoder's output into the context caches and ten serve steps
    in float32 (make_serve_step decodes through model.decoder): the logits
    at every step, and the decode state, ctx_kv included, through interop
    both ways."""
    jm, tcfg = whisper["jmodel"], whisper["tcfg"]
    batch = {"tokens": whisper["tokens"], "frames": whisper["frames"]}
    want = jax.jit(jsteps.make_prefill_step(jm))(
        whisper["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    model = tlm.EncDec(tcfg, attn_impl="flash", device="cpu")
    got = tsteps.make_prefill_step(model)(whisper["tparams"],
                                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(got.shape) == (2, tcfg.vocab_size)
    _close(got, want, BF16_REL)

    jenc = jm.encode(whisper["jparams"], jnp.asarray(whisper["frames"]),
                     compute_dtype=jnp.float32)
    jstate = jm.decoder.fill_context_caches(
        whisper["jparams"], jm.decoder.init_decode_state(2, 16, dtype=jnp.float32), jenc)
    enc = model.encode(whisper["tparams"], torch.from_numpy(whisper["frames"]), torch.float32)
    tstate = model.decoder.fill_context_caches(
        whisper["tparams"], model.decoder.init_decode_state(2, 16, dtype=torch.float32), enc)
    jstep = jax.jit(lambda p, t, s, pos: jm.decoder.decode_step(p, t, s, pos,
                                                                 compute_dtype=jnp.float32))
    serve = tsteps.make_serve_step(model)
    for pos in range(10):
        tok = whisper["tokens"][:, pos]
        want, jstate = jstep(whisper["jparams"], jnp.asarray(tok), jstate, jnp.int32(pos))
        got, tstate = model.decoder.decode_step(whisper["tparams"], torch.from_numpy(tok),
                                                tstate, pos, compute_dtype=torch.float32)
        _close(got, want, F32_REL)
    mine = interop.lm_decode_state_to_numpy(tstate)
    assert jax.tree.structure(mine) == jax.tree.structure(jstate)
    assert mine[1]["ctx_kv"]["k"].shape == (2, 2, 2, tcfg.encoder_frames, 16)
    for w, g in zip(jax.tree.leaves(jstate), jax.tree.leaves(mine)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= F32_REL * max(np.abs(w).max(), 1.0)
    back = interop.lm_decode_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                              dtype=torch.float32, device="cpu")
    again = interop.lm_decode_state_to_numpy(back)
    for g, w in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    # the serve step on the bf16 state the engine's default makes
    state = model.decoder.fill_context_caches(
        whisper["tparams"], model.decoder.init_decode_state(2, 16), enc)
    logits, state = serve(whisper["tparams"], state, torch.from_numpy(whisper["tokens"][:, 0]),
                          0)
    assert state[0][1]["ctx_kv"]["k"].dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, tcfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_flash_route_takes_only_what_the_kernel_takes(monkeypatch, whisper):
    """whisper's layout at SMOKE width with 150 frames (1500 / 10, which
    128 does not divide either): LM's flash route sends the decoder's
    self-attention layers (24 tokens, causal) to the wrapper and the
    encoder's layers and the cross layers to the chunked route, so the
    logits equal the chunked route's (float32)."""
    tcfg = dataclasses.replace(whisper["tcfg"], encoder_frames=150)
    params = tlm.EncDec(tcfg, device="cpu").init(torch.Generator().manual_seed(2))
    frames = torch.from_numpy(_frames(np.random.default_rng(7), 2, tcfg))
    tokens = torch.from_numpy(whisper["tokens"])
    calls = []
    real = fops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(fops, "flash_attention", spy)
    flash = tlm.EncDec(tcfg, attn_impl="flash", device="cpu").forward(params, tokens, frames,
                                                                     torch.float32)
    assert calls == [(24, 24, True)] * tcfg.n_superblocks
    chunked = tlm.EncDec(tcfg, device="cpu").forward(params, tokens, frames, torch.float32)
    _close(flash, chunked, F32_REL)


# --------------------------------------------------------------------- #
# training, build_model, launchers
# --------------------------------------------------------------------- #
def test_train_step_with_frames_matches_the_reference(whisper):
    """One AdamW step over {tokens, frames} in 2 microbatches from the same
    weights and batch; vision in an EncDec's batch raises."""
    jcfg, tcfg = whisper["jcfg"], whisper["tcfg"]
    rng = np.random.default_rng(13)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (4, 24)).astype(np.int32),
             "frames": _frames(rng, 4, tcfg)}
    jo = jopt.AdamWConfig(schedule=jopt.constant_schedule(STEP_LR))
    jp1, _, jmet = jsteps.make_train_step(jlm.EncDec(jcfg), jo, 2)(
        whisper["jparams"], jopt.adamw_init(whisper["jparams"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = interop.lm_params_from_numpy(whisper["tree"], tcfg, device="cpu")
    opt = topt.adamw_init(params)
    step = tsteps.make_train_step(tspecs.build_model(tcfg, device="cpu"),
                                  topt.AdamWConfig(schedule=topt.constant_schedule(STEP_LR)), 2)
    metrics = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[key]) / float(jmet[key]) - 1) <= LOSS_BF16_REL, key
    for want, g in zip(jax.tree.leaves(jp1), jax.tree.leaves(interop.lm_params_to_numpy(params))):
        assert (np.abs(g - np.asarray(want)) > STEP_LR).mean() <= SIGN_FLIP_FRAC
    with pytest.raises(ValueError, match="vision"):
        step(params, opt, {"tokens": torch.from_numpy(batch["tokens"]),
                           "vision": torch.zeros((4, 8, tcfg.d_model))})


def test_build_model_and_launchers(tmp_path):
    """build_model gives the audio family an EncDec with the knobs passed;
    the training launcher trains whisper SMOKE on the CPU from Piper's
    tokens and the reference's seeded frames; the serve launcher refuses the
    audio family with the reference's message."""
    cfg = tconfigs.get_smoke(ARCH)
    model = tspecs.build_model(cfg, attn_impl="flash", remat=False, ce_block=64, device="cpu")
    assert isinstance(model, tlm.EncDec) and isinstance(model.decoder, tlm.LM)
    assert (model.remat, model.attn_impl, model.decoder.ce_block) == (False, "flash", 64)
    out = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--rows", "64",
                        "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and all(np.isfinite(out["losses"]))
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.main(["--arch", ARCH, "--device", "cpu"])
