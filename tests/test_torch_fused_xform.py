"""The port's fused loop-② transform (repro_torch.kernels.fused_xform)
against the JAX package's Pallas kernels in interpret mode, at V = 257 and
5000. Ids and modded values are exact; dense is held at rtol 1e-6, because
CPU log1p differs by at most one ulp between the two frameworks. On the
CPU the wrappers take the plain versions; the CUDA kernel is held to them
in tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from tests._hypothesis_fallback import given, settings, strategies as st

from repro.core import vocab as jvocab
from repro.kernels.fused_xform import kernel as jfx_kernel
from repro.kernels.fused_xform import ops as jfx
from repro_torch.core import vocab as tvocab
from repro_torch.kernels.fused_xform import ops as tfx


def _inputs(seed, rows, n_sparse, n_dense, vocab_range):
    rng = np.random.default_rng(seed)
    sparse = rng.integers(-(2**31), 2**31 - 1, size=(rows, n_sparse), dtype=np.int64)
    dense = rng.integers(-(2**31), 2**31 - 1, size=(rows, n_dense), dtype=np.int64)
    dense[:, 0] = rng.integers(-5, 1000, size=rows)
    table = rng.integers(0, vocab_range, size=(n_sparse, vocab_range)).astype(np.int32)
    return sparse.astype(np.int32), dense.astype(np.int32), table


@pytest.mark.parametrize("vocab_range", [257, 5000])
@pytest.mark.parametrize("rows", [40, 256])
def test_fused_transform(vocab_range, rows):
    sparse, dense, table = _inputs(vocab_range + rows, rows, 26, 13, vocab_range)
    jv = jvocab.Vocabulary(table=jnp.asarray(table), sizes=jnp.zeros(26, jnp.int32))
    tv = tvocab.Vocabulary(table=torch.from_numpy(table), sizes=torch.zeros(26, dtype=torch.int32))
    wi, wd = jfx.fused_transform(jv, jnp.asarray(sparse), jnp.asarray(dense))
    gi, gd = tfx.fused_transform(tv, torch.from_numpy(sparse), torch.from_numpy(dense))
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


@pytest.mark.parametrize("vocab_range", [257, 5000])
def test_fused_mod_dense(vocab_range):
    rows = 64
    sparse, dense, _ = _inputs(vocab_range, rows, 26, 13, vocab_range)
    wm, wd = jfx_kernel.fused_mod_dense(
        jnp.asarray(sparse), jnp.asarray(dense), vocab_range=vocab_range, row_block=rows
    )
    gm, gd = tfx.fused_mod_dense(
        torch.from_numpy(sparse), torch.from_numpy(dense), vocab_range=vocab_range
    )
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


# -- the kernel's modulus: Lemire's fastmod from the wrapper's magic -------- #
_MASK32 = np.uint64(0xFFFFFFFF)


def _fastmod(v: np.ndarray, d: int) -> np.ndarray:
    """csrc/fused_xform.cu::fastmod in numpy uint64 (products wrap mod
    2**64 as on the card): hi64(lo64(M * v) * d), the high half built from
    32-bit halves as the kernel builds it."""
    m = np.uint64(tfx.fastmod_magic(d))
    v = v.astype(np.uint64)
    with np.errstate(over="ignore"):
        low = m * v
    hi = (low >> np.uint64(32)) * np.uint64(d) + (((low & _MASK32) * np.uint64(d)) >> np.uint64(32))
    return (hi >> np.uint64(32)).astype(np.uint32)


_EDGE_V = np.array([0, 1, 2, 3, 96, 97, 98, 4095, 4096, 4097, 4999, 5000, 5001, 999_999,
                    1_000_000, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                   dtype=np.uint64)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 13, 26, 97, 4096, 5000, 65536, 1_000_000,
                               2**30, 2**31 - 1])
def test_fastmod_is_exact_at_edge_values(d):
    """Every edge hash (0, d - 1, d, d + 1, int32 min/max as uint32,
    2**32 - 1, ...) and a seeded sample of 2**16 hashes, against %."""
    rng = np.random.default_rng(d)
    v = np.concatenate([_EDGE_V, np.array([d - 1, d, d + 1, 2 * d - 1, 2 * d], np.uint64)
                        % np.uint64(2**32),
                        rng.integers(0, 2**32, 2**16, dtype=np.uint64)])
    np.testing.assert_array_equal(_fastmod(v, d), (v % np.uint64(d)).astype(np.uint32))


def test_fastmod_is_exact_on_a_seeded_sample_of_divisors():
    rng = np.random.default_rng(19)
    for d in rng.integers(1, 2**31, 200):
        v = np.concatenate([_EDGE_V, rng.integers(0, 2**32, 4096, dtype=np.uint64)])
        np.testing.assert_array_equal(_fastmod(v, int(d)), (v % np.uint64(d)).astype(np.uint32))


def test_fastmod_magic_values_and_range():
    assert tfx.fastmod_magic(1) == 0  # 2**64 wraps: every product is 0, and so is v mod 1
    assert tfx.fastmod_magic(2) == 2**63
    assert tfx.fastmod_magic(3) == 2**64 // 3 + 1
    assert tfx.fastmod_magic(2**31 - 1) == -(-(2**64) // (2**31 - 1))
    for bad in (0, -1, 2**32):
        with pytest.raises(ValueError):
            tfx.fastmod_magic(bad)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 2**31 - 1))
def test_fastmod_property(v, d):
    assert int(_fastmod(np.array([v], np.uint64), d)[0]) == v % d
