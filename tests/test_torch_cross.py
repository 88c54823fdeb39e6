"""Cross-attention in the port against the JAX package: ``context_kv`` and
``cross_forward`` (the chunked route, the einsum oracle, the flash
wrapper's plain version), the flash route's choice by shape, and
llama-3.2-vision-90b at its SMOKE config (the config and parameter
count, ``LM.forward``, ``LM.loss`` and its gradients, the context caches
and decode steps, one AdamW step with ``vision`` in the batch).

Inputs and weights are made with numpy (the weights by the JAX package's
``init``, carried over with ``interop``; the patch embeddings as the
reference's launcher makes them, normal · 0.1) and go through both
packages. Tolerances, the ones earlier slices set, each beside the gap
measured on this CPU:
  * float32 compute: 1e-5 of the largest value (measured at most 1.4e-6);
  * bf16 compute: 4e-2 of the largest value (tests/test_torch_lm.py's
    BF16_REL; measured 2.5e-2 for the whole model, 4.0e-3 for one layer);
  * ``LM.loss`` in bf16: loss 1e-3 relative, every gradient
    |Δ|₂ ≤ 5e-2·|g|₂ (tests/test_torch_lm_train.py's; measured 3.5e-4 and
    at most 2.5e-2);
  * one AdamW step (lr 1e-3): the loss 1e-3 relative (measured 3.5e-4),
    at most 2% of a leaf's elements more than lr from the reference's
    (measured at most 1.6%); grad_norm within 5e-2 relative, the bound
    the per-leaf gradient tolerance implies (|‖g‖ − ‖w‖| ≤ ‖g − w‖), not
    tests/test_torch_lm_train.py's 1e-3: here the reference's own bf16
    grad_norm is 1.3e-3 from the float32 one that both packages agree on
    (13.2717, within 3e-8), and the port's bf16 one 7.5e-6 from it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train.tree import leaves, tree_map

ARCH = "llama-3.2-vision-90b"
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


def _stub(rng, batch, length, d):
    """The reference launcher's stub inputs: normal · 0.1, float32."""
    return rng.standard_normal((batch, length, d)).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def vlm():
    """llama-3.2-vision SMOKE in both packages: weights, tokens, patches."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jmodel = jlm.LM(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(8)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tparams=interop.lm_params_from_numpy(tree, tcfg, device="cpu"),
                tokens=rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32),
                vision=_stub(rng, 2, tcfg.vision_tokens, tcfg.d_model))


# --------------------------------------------------------------------- #
# the layer's functions
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def layer():
    """One cross layer's attention weights (llama-3.2-vision SMOKE: 4 query
    heads over 2 kv heads, D 16), 40 queries over 16 context states."""
    jcfg = jconfigs.get_smoke(ARCH)
    params = jattn.init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(9)
    return dict(jcfg=jcfg, tcfg=tconfigs.get_smoke(ARCH), params=params,
                tparams=jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params),
                x=rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32),
                context=rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32))


def test_context_kv_matches_the_reference(layer):
    """k and v [B, Hkv, Sc, D] of the context, handed on as strided views of
    the [B, Sc, Hkv, D] projections (the layout the kernel reads)."""
    jk, jv = jattn.context_kv(jnp.asarray(layer["context"]), layer["params"], layer["jcfg"])
    k, v = tattn.context_kv(torch.from_numpy(layer["context"]), layer["tparams"], layer["tcfg"])
    assert tuple(k.shape) == (2, layer["tcfg"].n_kv_heads, 16, layer["tcfg"].head_dim)
    assert not k.is_contiguous() and k.stride(3) == 1
    _close(k, jk, F32_REL)
    _close(v, jv, F32_REL)


@pytest.mark.parametrize("route", ["chunked", "einsum", "flash_plain"])
def test_cross_forward_matches_the_reference(route, layer):
    """cross_forward against the reference's (its chunked route), float32:
    the port's chunked route; the einsum oracle (not causal) on the same
    q, k, v; and the flash route, which on CPU tensors takes the wrapper's
    plain version (ref.mha)."""
    jcfg, tcfg, tp = layer["jcfg"], layer["tcfg"], layer["tparams"]
    jkv = jattn.context_kv(jnp.asarray(layer["context"]), layer["params"], jcfg)
    want = jattn.cross_forward(jnp.asarray(layer["x"]), jkv, layer["params"], jcfg)
    x = torch.from_numpy(layer["x"])
    kv = tattn.context_kv(torch.from_numpy(layer["context"]), tp, tcfg)
    if route == "einsum":
        q = tattn._split_heads(x @ tp["wq"]["w"], tcfg.n_heads)
        out = tattn.attention_einsum(q, *kv, causal=False)
        got = tattn._merge_heads(out) @ tp["wo"]["w"]
    else:
        got = tattn.cross_forward(x, kv, tp, tcfg, use_flash_kernel=route == "flash_plain")
    _close(got, want, F32_REL)


def test_cross_forward_casts_context_for_the_kernel(layer):
    """bf16 queries over float32 context k/v (the vision LM's patches are
    float32): the chunked route computes in float32 as the reference does;
    the flash route casts k/v to q's dtype, as the kernel needs one dtype."""
    jcfg, tcfg, tp = layer["jcfg"], layer["tcfg"], layer["tparams"]
    xb = jnp.asarray(layer["x"]).astype(jnp.bfloat16)
    jkv = jattn.context_kv(jnp.asarray(layer["context"]), layer["params"], jcfg)
    want = jattn.cross_forward(xb, jkv, layer["params"], jcfg)
    x = torch.from_numpy(layer["x"]).to(torch.bfloat16)
    kv = tattn.context_kv(torch.from_numpy(layer["context"]), tp, tcfg)
    for flash in (False, True):
        got = tattn.cross_forward(x, kv, tp, tcfg, use_flash_kernel=flash)
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16_REL)


@pytest.mark.parametrize("len_q,len_kv,causal,takes", [
    (4096, 1024, False, True), (4096, 4096, True, True), (256, 256, True, True),
    (256, 1500, False, False), (1500, 1500, False, False), (4096, 1024, True, False),
    (40, 16, False, True), (0, 16, False, False)])
def test_flash_takes_what_its_contract_takes(len_q, len_kv, causal, takes):
    """ops.takes, the route choice of the LM, agrees with the wrapper's own
    checks: where it says no, the wrapper raises."""
    assert fops.takes(len_q, len_kv, causal=causal) is takes
    if len_q:
        q, kv = torch.zeros((1, 2, len_q, 16)), torch.zeros((1, 2, len_kv, 16))
        if takes:
            fops._check_shapes(q, kv, kv, causal=causal)
        else:
            with pytest.raises(ValueError):
                fops._check_shapes(q, kv, kv, causal=causal)


# --------------------------------------------------------------------- #
# llama-3.2-vision-90b SMOKE
# --------------------------------------------------------------------- #
def test_config_and_param_count_match_the_reference():
    for name in ("get", "get_smoke"):
        j, t = getattr(jconfigs, name)(ARCH), getattr(tconfigs, name)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()
    assert tconfigs.get(ARCH).param_count() == 87_666_794_496
    assert ARCH in tconfigs.ARCH_IDS


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_forward_with_vision_matches_the_reference(dtype, vlm):
    """LM.forward with the patch embeddings as context, against the
    reference's: float32 on the chunked route, bf16 on the flash route,
    which takes every self-attention and cross layer here (the plain mha on
    the CPU)."""
    jdt, tdt = DTYPES[dtype]
    want, _ = jax.jit(lambda p, t, c: vlm["jmodel"].forward(p, t, c, compute_dtype=jdt))(
        vlm["jparams"], jnp.asarray(vlm["tokens"]), jnp.asarray(vlm["vision"]))
    model = tlm.LM(vlm["tcfg"], attn_impl="chunked" if dtype == "f32" else "flash",
                   device="cpu")
    got = model.forward(vlm["tparams"], torch.from_numpy(vlm["tokens"]), tdt,
                        context=torch.from_numpy(vlm["vision"]))
    assert got.dtype == tdt
    _close(got, want, F32_REL if dtype == "f32" else BF16_REL)


def test_flash_route_takes_the_self_and_cross_layers(monkeypatch, vlm):
    """LM(attn_impl="flash") calls the flash wrapper once per layer here (2
    self-attention, causal, 40 × 40; 2 cross, not causal, 40 × 16), and a
    cross layer without a context raises."""
    calls = []
    real = fops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(fops, "flash_attention", spy)
    model = tlm.LM(vlm["tcfg"], attn_impl="flash", device="cpu")
    model.forward(vlm["tparams"], torch.from_numpy(vlm["tokens"]), torch.float32,
                  context=torch.from_numpy(vlm["vision"]))
    assert sorted(calls) == [(40, 16, False)] * 2 + [(40, 40, True)] * 2
    with pytest.raises(ValueError, match="needs a context"):
        model.forward(vlm["tparams"], torch.from_numpy(vlm["tokens"]))


def test_lm_loss_and_every_gradient_match_the_reference(vlm):
    """LM.loss with vision, bf16 compute (the default), and the gradient of
    every parameter against jax.value_and_grad of the reference's."""
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t, c: vlm["jmodel"].loss(p, t, c)))(
        vlm["jparams"], jnp.asarray(vlm["tokens"]), jnp.asarray(vlm["vision"]))
    params = tsteps.trainable(interop.lm_params_from_numpy(vlm["tree"], vlm["tcfg"],
                                                           device="cpu"))
    loss = tlm.LM(vlm["tcfg"], device="cpu").loss(
        params, torch.from_numpy(vlm["tokens"]), context=torch.from_numpy(vlm["vision"]))
    loss.backward()
    assert abs(float(loss.detach()) / float(jl) - 1) <= LOSS_BF16_REL
    got = interop.lm_params_to_numpy(tree_map(lambda p: p.grad, params))
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, want), g in zip(paths, jax.tree.leaves(got)):
        assert _rel_l2(g, want) <= GRAD_BF16_REL_L2, jax.tree_util.keystr(path)


def test_context_caches_and_decode_match_the_reference(vlm):
    """fill_context_caches, then ten decode steps in float32: the logits at
    every step, the whole decode state (ctx_kv included) through interop's
    converters both ways; the port's decode against its own forward at every
    position; reset_decode_rows leaves ctx_kv alone; a context of another
    length raises."""
    jm, tcfg = vlm["jmodel"], vlm["tcfg"]
    model = tlm.LM(tcfg, device="cpu")
    vision = torch.from_numpy(vlm["vision"])
    jstate = jm.fill_context_caches(vlm["jparams"],
                                    jm.init_decode_state(2, 16, dtype=jnp.float32),
                                    jnp.asarray(vlm["vision"]))
    tstate = model.fill_context_caches(vlm["tparams"],
                                       model.init_decode_state(2, 16, dtype=torch.float32),
                                       vision)
    full = model.forward(vlm["tparams"], torch.from_numpy(vlm["tokens"][:, :10]),
                         torch.float32, context=vision)
    jstep = jax.jit(lambda p, t, s, pos: jm.decode_step(p, t, s, pos,
                                                         compute_dtype=jnp.float32))
    for pos in range(10):
        tok = vlm["tokens"][:, pos]
        want, jstate = jstep(vlm["jparams"], jnp.asarray(tok), jstate, jnp.int32(pos))
        got, tstate = model.decode_step(vlm["tparams"], torch.from_numpy(tok), tstate, pos,
                                        compute_dtype=torch.float32)
        _close(got, want, F32_REL)
        _close(got, full[:, pos], F32_REL)
    mine = interop.lm_decode_state_to_numpy(tstate)
    assert jax.tree.structure(mine) == jax.tree.structure(jstate)
    assert "ctx_kv" in mine[1] and mine[1]["ctx_kv"]["k"].shape == (2, 2, 2, 16, 16)
    for w, g in zip(jax.tree.leaves(jstate), jax.tree.leaves(mine)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= F32_REL * max(np.abs(w).max(), 1.0)
    back = interop.lm_decode_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                              dtype=torch.bfloat16, device="cpu")
    assert back[0][1]["ctx_kv"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(back[1][1]["ctx_kv"]["v"]), _np(
        torch.from_numpy(np.array(jstate[1]["ctx_kv"]["v"][1])).to(torch.bfloat16)))
    ctx = [c["ctx_kv"]["k"].clone() for sb in tstate for c in sb if "ctx_kv" in c]
    tlm.reset_decode_rows(tstate, [0])
    assert all(torch.equal(a, c["ctx_kv"]["k"])
               for a, c in zip(ctx, (c for sb in tstate for c in sb if "ctx_kv" in c)))
    with pytest.raises(ValueError, match="ctx_kv"):
        model.fill_context_caches(vlm["tparams"], tstate, vision[:, :8])


def test_prefill_step_passes_vision(vlm):
    """make_prefill_step hands batch["vision"] to the cross layers: the
    reference's prefill step's last logits, bf16."""
    want = jax.jit(jsteps.make_prefill_step(vlm["jmodel"]))(
        vlm["jparams"], {"tokens": jnp.asarray(vlm["tokens"]),
                         "vision": jnp.asarray(vlm["vision"])})
    model = tlm.LM(vlm["tcfg"], attn_impl="flash", device="cpu")
    got = tsteps.make_prefill_step(model)(
        vlm["tparams"], {"tokens": torch.from_numpy(vlm["tokens"]),
                         "vision": torch.from_numpy(vlm["vision"])})
    _close(got, want, BF16_REL)


def test_train_step_with_vision_matches_the_reference(vlm):
    """One AdamW step over {tokens, vision} in 2 microbatches from the same
    weights and batch; a key the LM does not read raises."""
    jcfg, tcfg = vlm["jcfg"], vlm["tcfg"]
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (4, 24)).astype(np.int32),
             "vision": _stub(rng, 4, tcfg.vision_tokens, tcfg.d_model)}
    jo = jopt.AdamWConfig(schedule=jopt.constant_schedule(STEP_LR))
    jp1, _, jm = jsteps.make_train_step(jlm.LM(jcfg), jo, 2)(
        vlm["jparams"], jopt.adamw_init(vlm["jparams"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = interop.lm_params_from_numpy(vlm["tree"], tcfg, device="cpu")
    opt = topt.adamw_init(params)
    step = tsteps.make_train_step(tlm.LM(tcfg, device="cpu"),
                                  topt.AdamWConfig(schedule=topt.constant_schedule(STEP_LR)), 2)
    metrics = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) / float(jm["loss"]) - 1) <= LOSS_BF16_REL
    assert abs(float(metrics["grad_norm"]) / float(jm["grad_norm"]) - 1) <= GRAD_BF16_REL_L2
    for want, g in zip(jax.tree.leaves(jp1), jax.tree.leaves(interop.lm_params_to_numpy(params))):
        assert (np.abs(g - np.asarray(want)) > STEP_LR).mean() <= SIGN_FLIP_FRAC
    with pytest.raises(ValueError, match="frames"):
        step(params, opt, {"tokens": torch.from_numpy(batch["tokens"]),
                           "frames": torch.zeros((4, 8, tcfg.d_model))})
    assert all(p.grad is None for p in leaves(params))
