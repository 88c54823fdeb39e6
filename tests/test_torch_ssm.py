"""The port's SSM blocks (Mamba, mLSTM, sLSTM) against the JAX package's,
and against themselves, as tests/test_ssm.py holds the reference.

Inputs and weights are made with numpy (the weights by the JAX package's
``*_init``) and go through both packages, float32. Tolerances, each beside
the gap measured on this CPU:
  * forward, decode steps and final states against the reference: 1e-5 of
    the largest value (measured at most 3.2e-7; Mamba's doubling scan
    groups the decay products otherwise than ``lax.associative_scan``);
  * the port's forward against its own decode chain, and across chunk
    sizes: tests/test_ssm.py's bounds on the reference (2e-4 Mamba, 5e-4
    mLSTM, 1e-5 the sLSTM state carry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.common import LayerSpec as JLayerSpec
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import SSMConfig as JSSMConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.common import LayerSpec, ModelConfig, SSMConfig
from repro_torch.train.tree import leaves

REL = 1e-5
KINDS = ["mamba", "mlstm", "slstm"]


def _cfg(kind, chunk=8, d=32, heads=4, package="torch"):
    """tests/test_ssm.py's config, in either package."""
    mc, ls, sc = ((ModelConfig, LayerSpec, SSMConfig) if package == "torch"
                  else (JModelConfig, JLayerSpec, JSSMConfig))
    return mc(name="t", family="ssm", d_model=d, n_heads=heads, n_kv_heads=heads,
              head_dim=d // heads, d_ff=0, vocab_size=64,
              superblock=(ls(kind=kind, mlp=""),), n_superblocks=1,
              ssm=sc(kind=kind, d_state=4, d_inner=d, chunk=chunk))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _params(kind, seed, cfg):
    p = {"mamba": jssm.mamba_init, "mlstm": jssm.mlstm_init,
         "slstm": jssm.slstm_init}[kind](jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(_t, tree)


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


FORWARD = {"mamba": (jssm.mamba_forward, tssm.mamba_forward),
           "mlstm": (jssm.mlstm_forward, tssm.mlstm_forward),
           "slstm": (jssm.slstm_forward, tssm.slstm_forward)}


def _state_list(state):
    return list(state) if isinstance(state, tuple) else [state]


# --------------------------------------------------------------------- #
# against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_the_reference(kind):
    """A sequence of 21 steps (a padded last chunk of 8) from the zero state,
    then 11 more from the returned state: outputs and every final state."""
    jcfg, tcfg = _cfg(kind, package="jax"), _cfg(kind)
    jp, tp = _params(kind, 1, jcfg)
    jf, tf = FORWARD[kind]
    jfj = jax.jit(jf, static_argnums=2)
    x = _x((2, 32, 32), 2)
    want, wstate = jfj(jnp.asarray(x[:, :21]), jp, jcfg)
    got, gstate = tf(_t(x[:, :21]), tp, tcfg)
    _close(got, want)
    for g, w in zip(_state_list(gstate), _state_list(wstate)):
        assert g.dtype == torch.float32
        _close(g, w)
    want, wstate = jfj(jnp.asarray(x[:, 21:]), jp, jcfg, wstate)
    got, gstate = tf(_t(x[:, 21:]), tp, tcfg, gstate)
    _close(got, want)
    for g, w in zip(_state_list(gstate), _state_list(wstate)):
        _close(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_steps_match_the_reference(kind):
    """Ten decode steps from the zero state against the reference's."""
    jcfg, tcfg = _cfg(kind, package="jax"), _cfg(kind)
    jp, tp = _params(kind, 3, jcfg)
    init = {"mamba": (jssm.mamba_init_state, tssm.mamba_init_state),
            "mlstm": (jssm.mlstm_init_state, tssm.mlstm_init_state),
            "slstm": (jssm.slstm_init_state, tssm.slstm_init_state)}[kind]
    dec = {"mamba": (jssm.mamba_decode, tssm.mamba_decode),
           "mlstm": (jssm.mlstm_decode, tssm.mlstm_decode),
           "slstm": (jssm.slstm_decode, tssm.slstm_decode)}[kind]
    jstate, tstate = init[0](2, jcfg), init[1](2, tcfg, device="cpu")
    for w, g in zip(_state_list(jstate), _state_list(tstate)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jstep = jax.jit(lambda x, s: dec[0](x, s, jp, jcfg))
    x = _x((10, 2, 1, 32), 4)
    for t in range(10):
        want, jstate = jstep(jnp.asarray(x[t]), jstate)
        got, tstate = dec[1](_t(x[t]), tstate, tp, tcfg)
        _close(got, want)
    for g, w in zip(_state_list(tstate), _state_list(jstate)):
        _close(g, w)


def test_params_match_the_reference_tree():
    for kind in KINDS:
        jcfg, tcfg = _cfg(kind, package="jax"), _cfg(kind)
        tree = jax.tree.map(np.asarray, _params(kind, 0, jcfg)[0])
        mine = {"mamba": tssm.mamba_init, "mlstm": tssm.mlstm_init,
                "slstm": tssm.slstm_init}[kind](None, tcfg, device="meta")
        assert sorted(tree) == sorted(mine), kind
        for a, b in zip(jax.tree.leaves(tree), leaves(mine)):
            assert tuple(a.shape) == tuple(b.shape), kind
    # the deterministic leaves are equal
    tree = jax.tree.map(np.asarray, _params("mamba", 0, _cfg("mamba", package="jax"))[0])
    mine = tssm.mamba_init(torch.Generator().manual_seed(0), _cfg("mamba"), device="cpu")
    for key in ("a_log", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(mine[key].numpy(), tree[key])


# --------------------------------------------------------------------- #
# the port against itself (tests/test_ssm.py)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,tol", [("mamba", 2e-4), ("mlstm", 5e-4)])
def test_forward_equals_decode_chain(kind, tol):
    cfg = _cfg(kind, chunk=8)
    _, p = _params(kind, 5, _cfg(kind, package="jax"))
    x = _t(_x((2, 24, 32), 6))
    y_par, st_par = FORWARD[kind][1](x, p, cfg)
    if kind == "mamba":
        state = tssm.mamba_init_state(2, cfg, device="cpu")
        step = tssm.mamba_decode
    else:
        state = tssm.mlstm_init_state(2, cfg, device="cpu")
        step = tssm.mlstm_decode
    ys = []
    for t in range(24):
        y_t, state = step(x[:, t:t + 1], state, p, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), atol=tol)
    np.testing.assert_allclose(_state_list(st_par)[0].numpy(), _state_list(state)[0].numpy(),
                               atol=tol)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_chunk_invariance(kind, chunk):
    """Chunks of 4, 8 and 24 over 24 steps, and of 5 (a padded last chunk),
    against one chunk of 24."""
    _, p = _params(kind, 7, _cfg(kind, package="jax"))
    x = _t(_x((1, 24, 32), 8))
    y24, _ = FORWARD[kind][1](x, p, _cfg(kind, chunk=24))
    for c in (chunk, 5):
        y, _ = FORWARD[kind][1](x, p, _cfg(kind, chunk=c))
        np.testing.assert_allclose(y.numpy(), y24.numpy(), atol=2e-4)


def test_slstm_state_carry():
    cfg = _cfg("slstm")
    _, p = _params("slstm", 3, _cfg("slstm", package="jax"))
    x = _t(_x((1, 12, 32), 9))
    y_all, st_all = tssm.slstm_forward(x, p, cfg)
    y_a, st_a = tssm.slstm_forward(x[:, :5], p, cfg)
    y_b, st_b = tssm.slstm_forward(x[:, 5:], p, cfg, state=st_a)
    np.testing.assert_allclose(y_all.numpy(), torch.cat([y_a, y_b], 1).numpy(), atol=1e-5)
    for a, b in zip(st_all, st_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_mamba_scan_keeps_long_chunks_finite():
    """A chunk of 128 steps whose decays run to exp(-16) a step: the
    doubling scan multiplies decays down to 0 without dividing, so every
    output stays finite and equals the step-by-step recurrence."""
    cfg = _cfg("mamba", chunk=128)
    _, p = _params("mamba", 10, _cfg("mamba", package="jax"))
    p["dt_bias"] = torch.full_like(p["dt_bias"], 4.0)  # delta ≈ 4, a down to -4·4
    x = _t(_x((1, 128, 32), 11) * 3)
    y, h = tssm.mamba_forward(x, p, cfg)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    state = tssm.mamba_init_state(1, cfg, device="cpu")
    for t in range(128):
        _, state = tssm.mamba_decode(x[:, t:t + 1], state, p, cfg)
    np.testing.assert_allclose(h.numpy(), state.numpy(), atol=2e-4)


def test_mlstm_forget_gate_decays_state():
    """With strongly negative forget pre-activations the state shrinks;
    with strongly positive ones it persists (tests/test_ssm.py)."""
    cfg = _cfg("mlstm", chunk=4)
    _, p = _params("mlstm", 4, _cfg("mlstm", package="jax"))
    x = _t(_x((1, 8, 32), 12))

    def run(bias):
        p2 = dict(p, w_gates=dict(p["w_gates"], b=torch.zeros(8).index_fill_(
            0, torch.arange(4, 8), bias)))
        _, (s, _) = tssm.mlstm_forward(x, p2, cfg)
        return float(torch.linalg.norm(s))

    assert run(-8.0) < run(8.0) * 0.5
