"""The port's DLRM (repro_torch.models.dlrm) and workload configs against the
JAX package: the same weights carried over with
``interop.dlrm_params_from_numpy``, the same numpy batches, then logits,
loss and every parameter's gradient against ``jax.value_and_grad(dlrm.loss)``.
At SMOKE (V = 257) at the full MLP widths, and at a narrow config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import piper_dlrm as jcfg
from repro.models import dlrm as jdlrm
from repro_torch import interop
from repro_torch.configs import piper_dlrm as tcfg
from repro_torch.models import dlrm as tdlrm
from repro_torch.train import steps as tsteps
from repro_torch.train.tree import leaves, leaves_with_paths

NARROW = dict(vocab_range=101, embed_dim=16, bottom_mlp=(32, 16), top_mlp=(32, 16, 1))
MODELS = {"smoke": {"vocab_range": 257}, "narrow": NARROW}


def _batch(seed, cfg, batch=128):
    rng = np.random.default_rng(seed)
    return {
        # Piper's dense output: log1p of non-negative counts
        "dense": np.log1p(rng.integers(0, 5000, (batch, cfg.n_dense))).astype(np.float32),
        "sparse": rng.integers(0, cfg.vocab_range, (batch, cfg.n_sparse)).astype(np.int32),
        "label": rng.integers(0, 2, batch).astype(np.int32),
    }


def _both(name, seed=0):
    jc = jdlrm.DLRMConfig(**MODELS[name])
    params = jdlrm.init(jax.random.PRNGKey(seed), jc)
    model = interop.dlrm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jc, params, model


@pytest.mark.parametrize("name", ["CONFIG_5K", "CONFIG_1M", "SMOKE"])
def test_configs_match_reference(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert t.name == j.name
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert t.model.n_pairs == j.model.n_pairs == 351
    js = j.pipeline.schema
    assert (t.schema.n_dense, t.schema.n_sparse, t.schema.vocab_range, t.schema.max_row_bytes) == (
        js.n_dense, js.n_sparse, js.vocab_range, js.max_row_bytes)
    pc = t.pipeline_config(device="cpu", max_rows_per_chunk=512)
    assert pc.schema == t.schema and pc.device == "cpu" and pc.max_rows_per_chunk == 512


@pytest.mark.parametrize("name", list(MODELS))
def test_params_round_trip_and_tree(name):
    """The reference's tree carries over exactly, with its shapes, and the
    port's own init draws the same shapes with the reference's statistics."""
    jc, params, model = _both(name)
    back = interop.dlrm_params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(params), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    g = torch.Generator().manual_seed(0)
    fresh = tdlrm.DLRM(tdlrm.DLRMConfig(**MODELS[name]), device="cpu", generator=g)
    paths = [p for p, _ in leaves_with_paths(fresh.params_tree())]
    jpaths = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert paths == jpaths
    for (p, x), y in zip(leaves_with_paths(fresh.params_tree()), jax.tree.leaves(params)):
        assert tuple(x.shape) == y.shape, p
        if p[-1] == "b":
            assert not x.any()
    # tables: normal · embed_dim**-0.5 (millions of draws at SMOKE: 1% holds)
    assert abs(float(fresh.tables.detach().std()) * jc.embed_dim**0.5 - 1) < 0.01
    again = tdlrm.DLRM(tdlrm.DLRMConfig(**MODELS[name]), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    for x, y in zip(leaves(fresh.params_tree()), leaves(again.params_tree())):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_loss_and_gradients_match_reference(name):
    """Tolerance: float32 products and sums of up to 512 terms in another
    order, whose rounding scales with the terms, not with the result (a
    logit near 0 is a sum of terms near 1). So logits and each gradient
    within 1e-5 of their own largest entry (measured: about 1e-6), the
    loss within rtol 1e-5."""
    jc, params, model = _both(name)
    batch = _batch(1, jc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_logits = np.asarray(jdlrm.forward(params, jb["dense"], jb["sparse"]))
    with torch.no_grad():
        got_logits = model(tb["dense"], tb["sparse"]).numpy()
    assert np.abs(got_logits - want_logits).max() <= 1e-5 * np.abs(want_logits).max()
    want_loss, want_grads = jax.value_and_grad(jdlrm.loss)(params, jb)
    got_loss, got_grads = tsteps.value_and_grad(tdlrm.loss, model, tb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for (path, g), w in zip(leaves_with_paths(got_grads), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, path


def test_forward_routes_through_the_embedding_gather(monkeypatch):
    """The model's embeddings come from kernels/embedding_bag, once per
    forward pass."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    calls = []
    real = eb_ops.embedding_gather
    monkeypatch.setattr(eb_ops, "embedding_gather",
                        lambda t, i: calls.append(i.shape) or real(t, i))
    jc, _, model = _both("narrow")
    tb = {k: torch.from_numpy(v) for k, v in _batch(2, jc, 16).items()}
    tdlrm.loss(model, tb).backward()
    assert calls == [(16, jc.n_sparse)]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdlrm.DLRM(tdlrm.DLRMConfig(**NARROW))


def test_bottom_mlp_must_end_at_embed_dim():
    with pytest.raises(ValueError, match="embed_dim"):
        tdlrm.DLRM(tdlrm.DLRMConfig(embed_dim=16, bottom_mlp=(32, 8)), device="cpu")
