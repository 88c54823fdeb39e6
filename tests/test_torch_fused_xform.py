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
