"""The port's language model against the JAX package, layer by layer and
whole, at gemma-2b's SMOKE config (d 64, 4 query heads, MQA, head_dim 16,
GeGLU, tied embeddings, 2 layers).

Inputs and weights are made with numpy (the weights by the JAX package's
``init``, carried over with ``interop.lm_params_from_numpy``) and go
through both packages. Tolerances:
  * float32 compute: 1e-5 absolute on values of order 1 (the same float32
    arithmetic, summed in another order by XLA and by torch);
  * bf16 compute: 4e-2 of the largest logit. bf16 keeps 8 significant bits
    (a relative step of 2^-8 = 3.9e-3); XLA rounds inside its fusions at
    other points than torch's eager ops, and two layers each add a few
    such roundings (measured: 1.4e-2 of the largest logit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import loader as jloader
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import loader as tloader
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.train import steps as tsteps

F32_TOL = 1e-5
BF16_REL = 4e-2
IMPLS = ["chunked", "einsum", "flash"]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    """gemma-2b SMOKE in both packages, the JAX init's weights in both."""
    jcfg = jconfigs.get_smoke("gemma-2b")
    tcfg = tconfigs.get_smoke("gemma-2b")
    jmodel = jlm.LM(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = interop.lm_params_from_numpy(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 48)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, jparams=jparams, tree=tree,
                tparams=tparams, tokens=tokens)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# --------------------------------------------------------------------- #
# configs and parameters
# --------------------------------------------------------------------- #
def test_configs_match_the_reference():
    for name in ("CONFIG", "SMOKE"):
        j = getattr(__import__("repro.configs.gemma_2b", fromlist=[name]), name)
        t = getattr(__import__("repro_torch.configs.gemma_2b", fromlist=[name]), name)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("whisper-large")


def test_param_count_matches_the_reference():
    assert tconfigs.get_smoke("gemma-2b").param_count() == \
        jconfigs.get_smoke("gemma-2b").param_count()
    # the full config, counted on the meta device (no memory)
    assert tconfigs.get("gemma-2b").param_count() == jconfigs.get("gemma-2b").param_count() \
        == 2_506_172_416


def test_params_round_trip(smoke):
    back = interop.lm_params_to_numpy(smoke["tparams"])
    same = jax.tree.map(np.array_equal, smoke["tree"], back)
    assert all(jax.tree.leaves(same))
    assert len(smoke["tparams"]["blocks"]) == smoke["tcfg"].n_superblocks
    bad = dict(smoke["tree"], embed=smoke["tree"]["embed"][:, :32])
    with pytest.raises(ValueError, match="embed"):
        interop.lm_params_from_numpy(bad, smoke["tcfg"], device="cpu")


def test_unported_layers_raise():
    """A layer the port does not know raises; every attention kind of the
    reference, cross included, builds."""
    cfg = dataclasses.replace(
        tconfigs.get_smoke("gemma-2b"),
        superblock=(tcommon.LayerSpec(kind="attn", attn="sliding", mlp="swiglu"),))
    with pytest.raises(ValueError, match="attn must be one of"):
        tlm.LM(cfg, device="cpu")
    for attn in ("causal", "bidir", "cross"):
        tlm.LM(dataclasses.replace(cfg, superblock=(tcommon.LayerSpec(attn=attn),)),
               device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tlm.LM(tconfigs.get_smoke("gemma-2b"), attn_impl="pallas", device="cpu")


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_common_layers(dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = _rand((2, 8, 32), 0)
    scale, bias = _rand((32,), 1), _rand((32,), 2)
    w, b = _rand((32, 16), 3, 0.2), _rand((16,), 4)
    jx, tx = jnp.asarray(x, jdt), _t(x, tdt)
    pairs = [
        (jcommon.rms_norm(jx, jnp.asarray(scale)), tcommon.rms_norm(tx, _t(scale))),
        (jcommon.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias)),
         tcommon.layer_norm(tx, _t(scale), _t(bias))),
        (jcommon.dense(jx, {"w": jnp.asarray(w), "b": jnp.asarray(b)}),
         tcommon.dense(tx, {"w": _t(w), "b": _t(b)})),
    ]
    for kind in ("geglu", "gelu", "swiglu", "relu2"):
        pairs.append((jcommon.activation(jx, kind), tcommon.activation(tx, kind)))
    pos = np.arange(8, dtype=np.int32) * 3
    pairs.append((jcommon.apply_rope(jx, jnp.asarray(pos), 10000.0),
                  tcommon.apply_rope(tx, torch.from_numpy(pos), 10000.0)))
    for j, t in pairs:
        assert t.dtype == tdt
        if dtype == "f32":
            np.testing.assert_allclose(_np(t), _np(j), atol=F32_TOL, rtol=F32_TOL)
        else:  # one rounding to bf16 apart at most
            np.testing.assert_allclose(_np(t), _np(j), atol=2**-7, rtol=2**-7)
    np.testing.assert_allclose(_np(tcommon.rope_freqs(256, 10000.0)),
                               _np(jcommon.rope_freqs(256, 10000.0)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu", "relu2"])
def test_mlp_forward(kind, smoke):
    cfg = smoke["tcfg"]
    params = jmlp.init(jax.random.PRNGKey(3), smoke["jcfg"], kind)
    tree = jax.tree.map(np.asarray, params)
    x = _rand((2, 8, cfg.d_model), 5)
    want = jmlp.forward(jnp.asarray(x), params, kind)
    got = tmlp.forward(_t(x), jax.tree.map(_t, tree), kind)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)
    assert set(tmlp.init(None, cfg, kind, device="cpu")) == set(tree)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_cores(window, causal):
    """einsum and chunked (several kv blocks, a padded one, query blocks)
    against the reference's, with a query offset."""
    q, k, v = _rand((2, 4, 96, 16), 6), _rand((2, 2, 96, 16), 7), _rand((2, 2, 96, 16), 8)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (_t(a) for a in (q, k, v))
    want = jattn.attention_einsum(jq, jk, jv, causal=causal, window=window, q_offset=5)
    got = tattn.attention_einsum(tq, tk, tv, causal=causal, window=window, q_offset=5)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)
    for bk, bq in ((40, 4096), (32, 32)):
        want = jattn.attention_chunked(jq, jk, jv, causal=causal, window=window, q_offset=5,
                                       block_k=bk, block_q=bq)
        got = tattn.attention_chunked(tq, tk, tv, causal=causal, window=window, q_offset=5,
                                      block_k=bk, block_q=bq)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


@pytest.mark.parametrize("route", ["chunked", "einsum", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_forward(route, dtype, smoke):
    cfg = smoke["tcfg"]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    params = jattn.init(jax.random.PRNGKey(4), smoke["jcfg"])
    tree = jax.tree.map(np.asarray, params)
    x = _rand((2, 32, cfg.d_model), 9)
    flash = route == "flash"
    want = jattn.forward(jnp.asarray(x, jdt), params, smoke["jcfg"],
                         impl="chunked" if flash else route, use_flash_kernel=flash, block_k=16)
    got = tattn.forward(_t(x, tdt), jax.tree.map(_t, tree), cfg,
                        impl="chunked" if flash else route, use_flash_kernel=flash, block_k=16)
    assert got.dtype == tdt
    _close(got, want, dtype)


def test_attention_decode_steps(smoke):
    """A run of decode steps into a full cache, float32, against the
    reference's (which returns a new cache where the port writes in place)."""
    cfg, jcfg = smoke["tcfg"], smoke["jcfg"]
    params = jattn.init(jax.random.PRNGKey(5), jcfg)
    tparams = jax.tree.map(_t, jax.tree.map(np.asarray, params))
    spec_j = jattn.CacheSpec("full", 12)
    spec_t = tattn.CacheSpec("full", 12)
    jc = jattn.init_cache(2, jcfg, spec_j, dtype=jnp.float32)
    tc = tattn.init_cache(2, cfg, spec_t, dtype=torch.float32, device="cpu")
    xs = _rand((10, 2, 1, cfg.d_model), 10)
    jstep = jax.jit(lambda x, c, pos: jattn.decode_step(x, c, pos, params, jcfg, spec=spec_j))
    for pos in range(10):
        want, jc = jstep(jnp.asarray(xs[pos]), jc, jnp.int32(pos))
        got, tc = tattn.decode_step(_t(xs[pos]), tc, pos, tparams, cfg, spec=spec_t)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), atol=F32_TOL)
    # a ring cache (sliding window) is filled slot by slot, -1 in the empty ones
    ring = tattn.init_cache(2, cfg, tattn.CacheSpec("ring", 8), device="cpu")
    assert ring["slot_pos"].tolist() == [-1] * 8 and "slot_pos" not in tc


# --------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_forward_and_prefill(impl, dtype, smoke):
    """LM.forward and make_prefill_step for every attention route, against
    the JAX LM's forward (its chunked route: the reference's LM never
    reaches its kernel) and its prefill step."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    tokens = smoke["tokens"]
    want, _ = smoke["jmodel"].forward(smoke["jparams"], jnp.asarray(tokens), compute_dtype=jdt)
    model = tlm.LM(smoke["tcfg"], attn_impl=impl, device="cpu")
    got = model.forward(smoke["tparams"], torch.from_numpy(tokens), compute_dtype=tdt)
    assert got.dtype == tdt
    _close(got, want, dtype)
    if dtype == "bf16":  # the prefill step's own compute dtype
        want = jsteps.make_prefill_step(smoke["jmodel"])(smoke["jparams"],
                                                         {"tokens": jnp.asarray(tokens)})
        got = tsteps.make_prefill_step(model)(smoke["tparams"],
                                              {"tokens": torch.from_numpy(tokens)})
        _close(got, want, dtype)
        nll_j = jlm.next_token_nll(want[None], jnp.asarray(tokens[None, :, 0]))
        nll_t = tlm.next_token_nll(got[None], torch.from_numpy(tokens[None, :, 0]))
        assert abs(float(nll_t) - float(nll_j)) <= BF16_REL * abs(float(nll_j))


def test_flash_route_launches_nothing_on_the_cpu(smoke):
    fops.KERNEL.launches = 0
    model = tlm.LM(smoke["tcfg"], attn_impl="flash", device="cpu")
    model.forward(smoke["tparams"], torch.from_numpy(smoke["tokens"]))
    assert fops.KERNEL.launches == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_decode_steps(dtype, smoke):
    """A prompt fed token by token through LM.decode_step, against the
    reference's decode_step at every position."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmodel, tokens = smoke["jmodel"], smoke["tokens"][:, :12]
    model = tlm.LM(smoke["tcfg"], device="cpu")
    jstate = jmodel.init_decode_state(2, 16, dtype=jdt)
    tstate = model.init_decode_state(2, 16, dtype=tdt)
    jstep = jax.jit(lambda p, t, s, pos: jmodel.decode_step(p, t, s, pos, compute_dtype=jdt))
    for pos in range(tokens.shape[1]):
        want, jstate = jstep(smoke["jparams"], jnp.asarray(tokens[:, pos]), jstate,
                             jnp.int32(pos))
        got, tstate = model.decode_step(smoke["tparams"], torch.from_numpy(tokens[:, pos]),
                                        tstate, pos, compute_dtype=tdt)
        _close(got, want, dtype)
    serve = tsteps.make_serve_step(model)
    again, _ = serve(smoke["tparams"], model.init_decode_state(2, 16, dtype=tdt),
                     torch.from_numpy(tokens[:, 0]), 0)
    assert again.shape == (2, smoke["tcfg"].vocab_size)


def test_decode_matches_forward(smoke):
    """The port's own decode equals its forward at every position, float32
    (tests/test_decode_consistency.py's check and bound)."""
    model = tlm.LM(smoke["tcfg"], device="cpu")
    tokens = torch.from_numpy(smoke["tokens"][:, :24])
    full = model.forward(smoke["tparams"], tokens, compute_dtype=torch.float32)
    state = model.init_decode_state(2, 24, dtype=torch.float32)
    for pos in range(24):
        lg, state = model.decode_step(smoke["tparams"], tokens[:, pos], state, pos,
                                      compute_dtype=torch.float32)
        assert float((lg - full[:, pos]).abs().max()) < 2e-3


# --------------------------------------------------------------------- #
# token batches
# --------------------------------------------------------------------- #
def test_token_batches_match_the_reference():
    for step in (0, 3):
        np.testing.assert_array_equal(tloader.TokenBatches(512, 2, 16, seed=4)(step)["tokens"],
                                      jloader.TokenBatches(512, 2, 16, seed=4)(step)["tokens"])
    sparse = np.random.default_rng(0).integers(0, 5000, (300, 26)).astype(np.int32)
    for step in (0, 1, 50):
        a = tloader.PiperTokenBatches(sparse, 512, 4, 64)(step)["tokens"]
        b = jloader.PiperTokenBatches(sparse, 512, 4, 64)(step)["tokens"]
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)

