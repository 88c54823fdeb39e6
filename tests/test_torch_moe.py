"""The port's MoE layer against the JAX package's, at qwen2-moe-a2.7b and
kimi-k2-1t-a32b SMOKE (8 experts, top-2, one shared expert).

Inputs and weights are made with numpy (the weights by the JAX package's
``moe_init`` / ``LM.init``, carried over with ``interop``) and go through
both packages. Tolerances, each beside the gap measured on this CPU:
  * routing (experts, positions within an expert, keep masks, drops):
    bit for bit;
  * the layer's output in float32: 1e-5 of its largest value (measured
    3.6e-7); the auxiliary loss 1e-6 relative (measured 0);
  * the layer in bf16 compute: 4e-2 of the largest value (BF16_REL of
    tests/test_torch_lm.py; measured 7.3e-3);
  * ``LM.loss`` with the auxiliary term in bf16 compute: 1e-3 relative
    (measured 5.9e-5), every gradient |Δ|₂ ≤ 5e-2·|g|₂ (measured at most
    1.81e-2), the bounds of tests/test_torch_lm_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.train.tree import leaves, tree_map

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
F32_REL = 1e-5
AUX_REL = 1e-6
BF16_REL = 4e-2
LOSS_BF16_REL = 1e-3
GRAD_BF16_REL_L2 = 5e-2


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _cfgs(arch, capacity_factor=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _reference_routing(xt, params, cfg):
    """The routing half of repro/models/mlp.py::_moe_forward_dense
    (:235-258), line for line: the float32 router, lax.top_k, the
    renormalised gates, the sort-based positions and the capacity."""
    m = cfg.moe
    logits = jcommon.dense(xt.astype(jnp.float32), params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, m.top_k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(m.n_experts))
    ranks_sorted = jnp.arange(flat_e.shape[0]) - start[sorted_e]
    pos = jnp.zeros_like(ranks_sorted).at[order].set(ranks_sorted)
    pos = pos.reshape(xt.shape[0], m.top_k).astype(jnp.int32)
    return {"logits": logits, "gates": gate_vals, "experts": expert_idx, "positions": pos,
            "keep": pos < jmlp._capacity(xt.shape[0], cfg)}


@pytest.fixture(scope="module")
def jitted():
    """The reference's functions, jitted once for the module."""
    return {
        "routing": jax.jit(_reference_routing, static_argnums=2),
        "moe": jax.jit(jmlp.moe_forward, static_argnums=(2, 3)),
    }


def _layer(arch, capacity_factor, seed):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    params = jmlp.moe_init(jax.random.PRNGKey(seed), jcfg, "swiglu")
    tree = jax.tree.map(np.asarray, params)
    x = (np.random.default_rng(seed).standard_normal((4, 24, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, params, tree_map(_t, tree), x


# --------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------- #
def test_top_k_breaks_ties_as_lax_top_k():
    """Rows full of equal values: torch.topk promises no order among them,
    the port's top_k takes the lower index first, as lax.top_k does."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 5, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmlp.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens,k,experts", [(37, 2, 8), (512, 8, 384), (1, 4, 60)])
def test_positions_in_expert_match_the_reference(tokens, k, experts):
    """Positions bit for bit on expert choices with many repeats (every
    expert of a small pool, and experts no token chose)."""
    rng = np.random.default_rng(tokens)
    choice = rng.integers(0, min(experts, 5), (tokens, k)).astype(np.int32)
    flat = jnp.asarray(choice).reshape(-1)
    order = jnp.argsort(flat, stable=True)
    start = jnp.searchsorted(flat[order], jnp.arange(experts))
    ranks = jnp.arange(flat.shape[0]) - start[flat[order]]
    want = jnp.zeros_like(ranks).at[order].set(ranks).reshape(tokens, k)
    got = tmlp.positions_in_expert(torch.from_numpy(choice).to(torch.int64), experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity_factor", [None, 1.0], ids=["smoke", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_the_reference_bit_for_bit(arch, capacity_factor, jitted):
    """Experts, positions, keep masks and drops of 96 tokens, at the SMOKE
    capacity (no drops) and at capacity_factor 1.0 (tokens dropped)."""
    jcfg, tcfg, params, tparams, x = _layer(arch, capacity_factor, 1)
    xt = x.reshape(-1, tcfg.d_model)
    want = jitted["routing"](jnp.asarray(xt), params, jcfg)
    got = tmlp.moe_route(torch.from_numpy(xt), tparams, tcfg)
    for key in ("experts", "positions", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["gates"].numpy(), np.asarray(want["gates"]), rtol=1e-6)
    assert got["capacity"] == jmlp._capacity(xt.shape[0], jcfg)
    dropped = int((~got["keep"]).sum())
    assert (dropped > 0) == (capacity_factor is not None), dropped


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("capacity_factor", [None, 1.0], ids=["smoke", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_the_reference(arch, capacity_factor, jitted):
    """The output (routed experts, drops, combine, shared expert) and the
    Switch auxiliary loss in float32; the output in bf16 compute."""
    jcfg, tcfg, params, tparams, x = _layer(arch, capacity_factor, 2)
    want, want_aux = jitted["moe"](jnp.asarray(x), params, jcfg, "swiglu")
    got, aux = tmlp.moe_forward(torch.from_numpy(x), tparams, tcfg, "swiglu")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= F32_REL * np.abs(want).max()
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= AUX_REL * abs(float(want_aux))
    # without the shared expert, the routed half alone
    routed = {k: v for k, v in tparams.items() if k != "shared"}
    got_r, _ = tmlp.moe_forward(torch.from_numpy(x), routed, tcfg, "swiglu")
    want_r, _ = jitted["moe"](jnp.asarray(x), {k: v for k, v in params.items()
                                               if k != "shared"}, jcfg, "swiglu")
    want_r = np.asarray(want_r)
    assert np.abs(got_r.numpy() - want_r).max() <= F32_REL * np.abs(want_r).max()
    # bf16 compute
    want_b, _ = jitted["moe"](jnp.asarray(x, jnp.bfloat16), params, jcfg, "swiglu")
    got_b, _ = tmlp.moe_forward(_t(x, torch.bfloat16), tparams, tcfg, "swiglu")
    assert got_b.dtype == torch.bfloat16
    want_b = np.asarray(want_b, np.float32)
    assert np.abs(got_b.float().numpy() - want_b).max() <= BF16_REL * np.abs(want_b).max()


def test_moe_params_match_the_reference_tree():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    tree = jax.tree.map(np.asarray, jmlp.moe_init(jax.random.PRNGKey(0), jcfg, "swiglu"))
    mine = tmlp.moe_init(None, tcfg, "swiglu", device="meta")
    assert jax.tree.structure(tree) == jax.tree.structure(
        tree_map(lambda t: np.zeros(t.shape), mine))
    for a, b in zip(jax.tree.leaves(tree), leaves(mine)):
        assert tuple(a.shape) == tuple(b.shape)


# --------------------------------------------------------------------- #
# LM.loss with the auxiliary term
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_aux_and_its_gradient_match_the_reference(arch):
    """LM.loss (chunked CE + 0.01 · the layers' summed auxiliary loss) and
    every parameter's gradient against jax.value_and_grad of the
    reference's LM.loss, bf16 compute; the summed auxiliary loss itself in
    float32."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jmodel = jlm.LM(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jnp.asarray(tokens))))(jparams)
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    model = tlm.LM(tcfg, device="cpu")
    loss = model.loss(params, torch.from_numpy(tokens))
    loss.backward()
    assert abs(float(loss.detach()) / float(jl) - 1) <= LOSS_BF16_REL
    got = interop.lm_params_to_numpy(tree_map(lambda p: p.grad, params))
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(got)):
        want = np.asarray(want, np.float64)
        gap = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert gap <= GRAD_BF16_REL_L2, (jax.tree_util.keystr(path), gap)
    with torch.no_grad():
        _, aux = model.trunk(params, torch.from_numpy(tokens), compute_dtype=torch.float32)
    _, want_aux = jmodel.hidden(jparams, jnp.asarray(tokens), compute_dtype=jnp.float32)
    assert float(want_aux) > 0
    assert abs(float(aux) - float(want_aux)) <= AUX_REL * float(want_aux)
