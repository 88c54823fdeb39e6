"""The MoE, SSM and hybrid decoder families in the port against the JAX
package: qwen2-moe-a2.7b, kimi-k2-1t-a32b, hymba-1.5b and xlstm-350m at
their SMOKE configs (the configs, parameter counts, parameter and
decode-state trees, LM.forward, decode steps, the ring KV cache, the flash
route's layer choice, the serving engine).

Inputs and weights are made with numpy (the weights by the JAX package's
``init``, carried over with ``interop``) and go through both packages.
Tolerances, each beside the gap measured on this CPU:
  * float32 compute: 1e-5 of the largest logit (measured at most 1.2e-6);
    hymba at 5e-5 (measured 8.6e-6 forward, 1.17e-5 decoding through
    rings of 8: its Mamba scans group products otherwise, and its
    rms-normalised Mamba outputs amplify that);
  * bf16 compute: 4e-2 of the largest logit (BF16_REL of
    tests/test_torch_lm.py; measured at most 1.6e-2). hymba SMOKE's whole
    model amplifies a bf16 rounding (its Mamba outputs are rms-normalised,
    and some tokens' are 250x smaller than others'): the reference's own
    bf16 and float32 logits differ by 0.75 of the largest logit. So hymba
    is held in bf16 layer by layer on the reference's inputs at 4e-2
    (measured 8.4e-3), and whole at half its own bf16-to-float32 gap
    (measured 0.23 against a bound of 0.38);
  * integers (ring slots, routing) bit for bit; the engines' greedy tokens
    equal, in float32 for every family and in bf16 (the engines' default)
    for qwen2-moe and xlstm. hymba's engines in bf16 agree on 10 of 12
    tokens: at request 1's fourth token its two largest logits are one bf16
    step apart (3.015625 and 3.0) in both packages, which take different
    tokens, and request 2 goes on from another state.
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
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import leaves, tree_map

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m"]
F32_REL = {"hymba-1.5b": 5e-5}
F32_REL_DEFAULT = 1e-5
BF16_REL = 4e-2
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


def _build(arch, cfg_change=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if cfg_change:
        jcfg, tcfg = cfg_change(jcfg), cfg_change(tcfg)
    jmodel = jlm.LM(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(ARCHS.index(arch) if arch in ARCHS else 0))
    tree = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tparams=interop.lm_params_from_numpy(tree, tcfg, device="cpu"),
                tokens=np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 40))
                .astype(np.int32))


@pytest.fixture(scope="module")
def zoo():
    """Each arch's SMOKE in both packages, built once for the module."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _build(arch)
        return built[arch]

    return get


def _jit_decode(m, dtype):
    return jax.jit(lambda p, t, s, pos: m["jmodel"].decode_step(p, t, s, pos,
                                                                 compute_dtype=dtype))


# --------------------------------------------------------------------- #
# configs and parameters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_the_reference(arch):
    """CONFIG and SMOKE equal as dataclasses; parameter counts equal on the
    full configs (the port counts on the meta device, so kimi-k2's 1.03 T
    parameters take no memory) and at SMOKE."""
    for name in ("CONFIG", "SMOKE"):
        j = getattr(jconfigs, "get" if name == "CONFIG" else "get_smoke")(arch)
        t = getattr(tconfigs, "get" if name == "CONFIG" else "get_smoke")(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()
    assert arch in tconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_both_ways(arch, zoo):
    """The reference's tree → the port → numpy is the same tree; the port's
    own init → numpy → the port is the same parameters, and so is the LM
    trainer's checkpoint tree (AdamW state included) with every new leaf."""
    m = zoo(arch)
    back = interop.lm_params_to_numpy(m["tparams"])
    assert jax.tree.structure(back) == jax.tree.structure(m["tree"])
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, m["tree"], back)))
    own = tlm.LM(m["tcfg"], device="cpu").init(torch.Generator().manual_seed(1))
    again = interop.lm_params_from_numpy(interop.lm_params_to_numpy(own), m["tcfg"],
                                         device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(own), leaves(again)))
    # the trainer's checkpoint tree (parameters and AdamW state) both ways
    opt = topt.adamw_init(own)
    opt["m"] = tree_map(lambda t: t + 1.0, opt["m"])
    state = interop.lm_train_state_to_numpy(own, opt)
    like = interop.lm_train_state_like(m["tcfg"])
    assert [tuple(t.shape) for t in leaves(like)] == [a.shape for a in leaves(state)]
    params, opt2 = interop.lm_train_state_from_numpy(state, m["tcfg"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves((own, opt)), leaves((params, opt2))))


# --------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_the_reference(arch, dtype, zoo):
    """LM.forward against the reference's (its chunked route), float32 on
    the chunked route and bf16 on the flash route (the plain mha on the
    CPU for layers without a window), with the MoE auxiliary loss."""
    m = zoo(arch)
    jdt, tdt = DTYPES[dtype]
    want, want_aux = jax.jit(lambda p, t: m["jmodel"].forward(p, t, compute_dtype=jdt))(
        m["jparams"], jnp.asarray(m["tokens"]))
    model = tlm.LM(m["tcfg"], attn_impl="chunked" if dtype == "f32" else "flash", device="cpu")
    tokens = torch.from_numpy(m["tokens"])
    got = model.forward(m["tparams"], tokens, compute_dtype=tdt)
    assert got.dtype == tdt
    rel = F32_REL.get(arch, F32_REL_DEFAULT) if dtype == "f32" else BF16_REL
    if dtype == "bf16" and arch == "hymba-1.5b":  # see the module's docstring
        want32, _ = jax.jit(lambda p, t: m["jmodel"].forward(p, t, compute_dtype=jnp.float32))(
            m["jparams"], jnp.asarray(m["tokens"]))
        rel = 0.5 * np.abs(_np(want) - _np(want32)).max() / np.abs(_np(want)).max()
    _close(got, want, rel)
    if dtype == "f32":
        _, aux = model.trunk(m["tparams"], tokens, compute_dtype=tdt)
        assert abs(float(aux) - float(want_aux)) <= 1e-6 * max(float(want_aux), 1.0)
        assert (float(aux) > 0) == (m["tcfg"].moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_states_match_the_reference(arch, zoo):
    """Twelve decode steps, float32: the logits at every step, then the
    whole decode state (KV caches, ring slots, recurrent states) through
    interop's converters, and the reverse conversion."""
    m = zoo(arch)
    jstep = _jit_decode(m, jnp.float32)
    model = tlm.LM(m["tcfg"], device="cpu")
    jstate = m["jmodel"].init_decode_state(2, 16, dtype=jnp.float32)
    tstate = model.init_decode_state(2, 16, dtype=torch.float32)
    rel = F32_REL.get(arch, F32_REL_DEFAULT)
    for pos in range(12):
        want, jstate = jstep(m["jparams"], jnp.asarray(m["tokens"][:, pos]), jstate,
                             jnp.int32(pos))
        got, tstate = model.decode_step(m["tparams"], torch.from_numpy(m["tokens"][:, pos]),
                                        tstate, pos, compute_dtype=torch.float32)
        _close(got, want, rel)
    mine = interop.lm_decode_state_to_numpy(tstate)
    assert jax.tree.structure(mine) == jax.tree.structure(jstate)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jstate), jax.tree.leaves(mine)):
        w = np.asarray(w)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1.0), \
                jax.tree_util.keystr(path)
    back = interop.lm_decode_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                              dtype=torch.float32, device="cpu")
    assert [[sorted(c) for c in sb] for sb in back] == [[sorted(c) for c in sb] for sb in tstate]
    again = interop.lm_decode_state_to_numpy(back)
    for g, w in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


# --------------------------------------------------------------------- #
# hymba and the ring cache
# --------------------------------------------------------------------- #
def _window(w):
    def change(cfg):
        return dataclasses.replace(cfg, superblock=tuple(
            dataclasses.replace(s, window=w) if s.window else s for s in cfg.superblock))
    return change


def test_ring_cache_wraps_as_the_reference():
    """attention.decode_step on a ring cache of 8 slots (window 8) over 24
    steps: outputs, the cache and slot_pos (bit for bit) at every step."""
    jcfg, tcfg = jconfigs.get_smoke("hymba-1.5b"), tconfigs.get_smoke("hymba-1.5b")
    params = jattn.init(jax.random.PRNGKey(5), jcfg)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    jspec, tspec = jattn.CacheSpec("ring", 8), tattn.CacheSpec("ring", 8)
    jc = jattn.init_cache(2, jcfg, jspec, dtype=jnp.float32)
    tc = tattn.init_cache(2, tcfg, tspec, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    xs = (np.random.default_rng(10).standard_normal((24, 2, 1, tcfg.d_model))).astype(np.float32)
    jstep = jax.jit(lambda x, c, pos: jattn.decode_step(x, c, pos, params, jcfg, spec=jspec,
                                                        window=8))
    for pos in range(24):
        want, jc = jstep(jnp.asarray(xs[pos]), jc, jnp.int32(pos))
        got, tc = tattn.decode_step(torch.from_numpy(xs[pos]), tc, pos, tparams, tcfg,
                                    spec=tspec, window=8)
        _close(got, want, F32_REL_DEFAULT)
        assert tc["slot_pos"].dtype == torch.int32
        np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
    assert sorted(tc["slot_pos"].tolist()) == list(range(16, 24))
    with pytest.raises(ValueError, match="cache kind"):
        tattn.init_cache(2, tcfg, tattn.CacheSpec("paged", 8), device="cpu")


def test_hymba_ring_decode_matches_the_reference_and_forward():
    """hymba SMOKE with its sliding windows cut to 8: 24 decode steps into
    a 24-token cache (the windowed layers' rings of 8 wrap twice) against
    the reference's decode (logits and slot_pos), and the port's decode
    against its own forward at every position (float32)."""
    m = _build("hymba-1.5b", _window(8))
    model = tlm.LM(m["tcfg"], device="cpu")
    tokens = m["tokens"][:, :24]
    full = model.forward(m["tparams"], torch.from_numpy(tokens), compute_dtype=torch.float32)
    jstep = _jit_decode(m, jnp.float32)
    jstate = m["jmodel"].init_decode_state(2, 24, dtype=jnp.float32)
    tstate = model.init_decode_state(2, 24, dtype=torch.float32)
    ring = [c["kv"]["slot_pos"] for sb in tstate for c in sb if "slot_pos" in c["kv"]]
    assert len(ring) == 2 and all(r.shape == (8,) for r in ring)
    for pos in range(24):
        want, jstate = jstep(m["jparams"], jnp.asarray(tokens[:, pos]), jstate, jnp.int32(pos))
        got, tstate = model.decode_step(m["tparams"], torch.from_numpy(tokens[:, pos]), tstate,
                                        pos, compute_dtype=torch.float32)
        _close(got, want, F32_REL["hymba-1.5b"])
        assert float((got - full[:, pos]).abs().max()) < 2e-3
    for j, spec in enumerate(m["tcfg"].superblock):
        if spec.window:
            for i in range(m["tcfg"].n_superblocks):
                np.testing.assert_array_equal(tstate[i][j]["kv"]["slot_pos"].numpy(),
                                              np.asarray(jstate[j]["kv"]["slot_pos"][i]))


def test_hymba_block_matches_the_reference():
    """One hymba block with a window (attention and Mamba heads in
    parallel, x + 0.5·(rms(a) + rms(m)), then the MLP), float32, on the
    chunked and einsum routes."""
    jcfg, tcfg = jconfigs.get_smoke("hymba-1.5b"), tconfigs.get_smoke("hymba-1.5b")
    spec_j, spec_t = jcfg.superblock[1], tcfg.superblock[1]
    assert spec_t.kind == "hymba" and spec_t.window == 32
    p = jlm._block_init(jax.random.PRNGKey(6), spec_j, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = (np.random.default_rng(11).standard_normal((2, 48, tcfg.d_model))).astype(np.float32)
    for impl in ("chunked", "einsum"):
        want, _ = jax.jit(lambda a: jlm._block_forward(a, p, spec_j, jcfg, context=None,
                                                       impl=impl, block_k=16))(jnp.asarray(x))
        got, aux = tlm._block_forward(torch.from_numpy(x), tp, spec_t, tcfg, impl=impl,
                                      block_k=16)
        _close(got, want, F32_REL["hymba-1.5b"])
        assert float(aux) == 0.0


def test_hymba_layers_in_bf16_match_the_reference(zoo):
    """Every layer of hymba SMOKE in bf16 compute, each on the reference's
    own input stream (the embedding, then each reference layer's output),
    at BF16_REL."""
    m = zoo("hymba-1.5b")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    x = m["jparams"]["embed"][jnp.asarray(m["tokens"])].astype(jnp.bfloat16)
    blocks = [jax.jit(lambda a, p, s=s: jlm._block_forward(a, p, s, jcfg, context=None,
                                                           impl="chunked")[0])
              for s in jcfg.superblock]
    for i in range(tcfg.n_superblocks):
        for j, spec in enumerate(tcfg.superblock):
            jp = jax.tree.map(lambda a: a[i], m["jparams"]["blocks"][j])
            got, _ = tlm._block_forward(torch.from_numpy(_np(x)).to(torch.bfloat16),
                                        m["tparams"]["blocks"][i][j], spec, tcfg, impl="chunked")
            x = blocks[j](x, jp)
            _close(got, x, BF16_REL)


def test_flash_route_takes_only_layers_without_a_window(monkeypatch, zoo):
    """LM(attn_impl="flash") on hymba SMOKE calls the flash wrapper on its
    global layers only (one of the two specs, in each of 2 superblocks)
    and launches nothing on the CPU; the windowed layers take the chunked
    route, so the logits equal the chunked route's."""
    m = zoo("hymba-1.5b")
    calls = []
    real = fops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(fops, "flash_attention", spy)
    fops.KERNEL.launches = 0
    tokens = torch.from_numpy(m["tokens"][:, :32])
    flash = tlm.LM(m["tcfg"], attn_impl="flash", device="cpu").forward(
        m["tparams"], tokens, compute_dtype=torch.float32)
    assert len(calls) == 2 and fops.KERNEL.launches == 0
    chunked = tlm.LM(m["tcfg"], device="cpu").forward(m["tparams"], tokens,
                                                      compute_dtype=torch.float32)
    _close(flash, chunked, F32_REL_DEFAULT)
    with pytest.raises(ValueError, match="no sliding window"):
        tattn.forward(torch.zeros((1, 32, 64)), m["tparams"]["blocks"][0][1]["attn"], m["tcfg"],
                      window=32, use_flash_kernel=True)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
class _AtDtype:
    """An LM whose decode steps and caches take ``dtype`` (the engines call
    ``decode_step`` and ``init_decode_state`` with their defaults, bf16)."""

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype
        self.device = getattr(model, "device", None)

    def init_decode_state(self, batch, cache_len):
        return self.model.init_decode_state(batch, cache_len, dtype=self.dtype)

    def decode_step(self, params, token, state, pos):
        return self.model.decode_step(params, token, state, pos, compute_dtype=self.dtype)


def _serve(lib, model, params, prompts):
    """``prompts`` through ``lib``'s engine, 2 slots, 4 new tokens each:
    the generated tokens and the engine."""
    eng = lib.ServeEngine(model, params, batch_slots=2, cache_len=16)
    reqs = [lib.Request(prompt=list(p), max_new_tokens=4) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    return [r.generated for r in reqs], eng


def _prompts(m):
    rng = np.random.default_rng(3)
    return [rng.integers(0, m["tcfg"].vocab_size, 5).tolist() for _ in range(3)]


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-moe-a2.7b", "bf16"), ("xlstm-350m", "bf16"), ("qwen2-moe-a2.7b", "f32"),
    ("hymba-1.5b", "f32"), ("xlstm-350m", "f32")])
def test_engine_generates_the_reference_engines_tokens(arch, dtype, zoo):
    """The port's engine, 2 slots and 3 requests (two waves), on the JAX
    init's weights: the greedy tokens of the reference's engine serving
    each wave on its own (argmax, so this holds while no two logits of a
    step lie within the packages' rounding difference; true for these
    fixed weights and prompts, but for hymba in bf16, see the module's
    docstring). The reference's engine serving both waves keeps a slot's
    recurrent states for its next request (ROADMAP queue 3), so its second
    wave is not the reference here."""
    m = zoo(arch)
    jdt, tdt = DTYPES[dtype]
    prompts = _prompts(m)
    jmodel = _AtDtype(m["jmodel"], jdt)
    want = (_serve(jengine, jmodel, m["jparams"], prompts[:2])[0]
            + _serve(jengine, jmodel, m["jparams"], prompts[2:])[0])
    got, _ = _serve(tengine, _AtDtype(tlm.LM(m["tcfg"], device="cpu"), tdt), m["tparams"],
                    prompts)
    assert got == want


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_engine_serves_a_later_request_as_if_alone(arch, zoo):
    """A request given a slot that served another request gets the tokens,
    and its slot ends with the recurrent states, that it gets served alone
    (float32): the slot's Mamba, mLSTM and sLSTM states start anew."""
    m = zoo(arch)
    model = _AtDtype(tlm.LM(m["tcfg"], device="cpu"), torch.float32)
    prompts = _prompts(m)
    got, both = _serve(tengine, model, m["tparams"], prompts)
    want, alone = _serve(tengine, model, m["tparams"], prompts[2:])
    assert got[2] == want[0]
    states = [(a, b) for sa, sb in zip(both.state, alone.state) for ca, cb in zip(sa, sb)
              for (a, _), (b, _) in zip(tlm._recurrent_states(ca), tlm._recurrent_states(cb))]
    assert states
    for a, b in states:
        torch.testing.assert_close(a[0], b[0])
