"""The port's stateless operators (repro_torch.core.ops) against the JAX
package's on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import vocab as jvocab
from repro_torch.core import ops as tops
from repro_torch.core import vocab as tvocab


@pytest.fixture(scope="module")
def hashes():
    rng = np.random.default_rng(5)
    h = rng.integers(-(2**31), 2**31 - 1, size=(64, 4), dtype=np.int64).astype(np.int32)
    h[0] = [0, -1, -(2**31), 2**31 - 1]
    return h


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(6)
    d = rng.integers(-1000, 10**6, size=(64, 13)).astype(np.int32)
    d[0, :4] = [-(2**31), 2**31 - 1, 0, -1]
    return d


@pytest.mark.parametrize("vocab_range", [1, 97, 5000, 1_000_000, 2**31 - 1])
def test_positive_modulus(hashes, vocab_range):
    want = np.asarray(jops.positive_modulus(jnp.asarray(hashes), vocab_range))
    got = tops.positive_modulus(torch.from_numpy(hashes), vocab_range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_cross(hashes):
    want = np.asarray(jops.hash_cross(jnp.asarray(hashes[:, 0]), jnp.asarray(hashes[:, 1])))
    got = tops.hash_cross(torch.from_numpy(hashes[:, 0]), torch.from_numpy(hashes[:, 1]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_operators(dense):
    x, tx = jnp.asarray(dense), torch.from_numpy(dense)
    np.testing.assert_array_equal(tops.neg2zero(tx).numpy(), np.asarray(jops.neg2zero(x)))
    # CPU log1p differs by at most one ulp between the two frameworks
    for name, args in (("logarithm", ()), ("dense_transform", ()),
                       ("clip", (-5.0, 300.0)), ("minmax_scale", (-5.0, 300.0))):
        want = np.asarray(getattr(jops, name)(jnp.abs(x) if name == "logarithm" else x, *args))
        got = getattr(tops, name)(tx.abs() if name == "logarithm" else tx, *args)
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=name)
    edges = (-10.0, 0.0, 0.5, 100.0, 5000.0)
    np.testing.assert_array_equal(
        tops.bucketize(tx, edges).numpy(), np.asarray(jops.bucketize(x, edges))
    )


@pytest.mark.parametrize("use_kernel", [True, False], ids=["fused", "unfused"])
def test_fused_dispatchers(hashes, dense, use_kernel):
    """Both dispatchers, kernel route (the plain version on the CPU) and
    the unfused chain, equal the reference's unfused chain."""
    rng = np.random.default_rng(7)
    vocab_range = 97
    table = rng.integers(0, 50, size=(4, vocab_range)).astype(np.int32)
    jv = jvocab.Vocabulary(table=jnp.asarray(table), sizes=jnp.zeros(4, jnp.int32))
    tv = tvocab.Vocabulary(table=torch.from_numpy(table), sizes=torch.zeros(4, dtype=torch.int32))
    wi, wd = jops.fused_transform(jv, jnp.asarray(hashes), jnp.asarray(dense), use_kernel=False)
    gi, gd = tops.fused_transform(tv, torch.from_numpy(hashes), torch.from_numpy(dense),
                                  use_kernel=use_kernel)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)

    valid = rng.random(64) < 0.9
    js = jops.fused_vocab_update(jvocab.VocabState.init(4, vocab_range, track_counts=True),
                                 jnp.asarray(hashes), jnp.asarray(valid), use_kernel=False)
    ts = tops.fused_vocab_update(
        tvocab.VocabState.init(4, vocab_range, track_counts=True, device="cpu"),
        torch.from_numpy(hashes), torch.from_numpy(valid), use_kernel=use_kernel)
    np.testing.assert_array_equal(ts.first_pos.numpy(), np.asarray(js.first_pos))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert int(ts.rows_seen) == int(js.rows_seen)
