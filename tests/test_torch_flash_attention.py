"""The port's flash-attention wrapper against the JAX package's kernel.

The same numpy inputs go through ``repro.kernels.flash_attention.kernel.
flash_attention`` (Pallas, interpret mode, as tests/test_kernels_flash.py
runs it), ``repro``'s ``ref.mha`` and the port's ``flash_attention``, which
takes its plain version (``ref.mha``) on CPU tensors. Tolerances are the
reference's own (tests/test_kernels_flash.py:21): 2e-5 in float32 (another
summation order), 2e-2 in bf16 (the Pallas kernel rounds its inputs to bf16
and accumulates in float32 blocks; the plain version works on the same bf16
values in one float32 softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.models import attention as tattn

DTYPES = [(jnp.float32, torch.float32, 2e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)]


def _inputs(shapes, seed, jdt, tdt):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype=jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 128, 64),   # MHA
    (2, 8, 2, 256, 64),   # GQA, group 4
    (1, 8, 1, 256, 128),  # MQA, gemma's head map
])
def test_plain_route_matches_pallas_kernel_and_ref(b, hq, hkv, s, d, causal, jdt, tdt, tol):
    (jq, jk, jv), (q, k, v) = _inputs([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], 0, jdt,
                                      tdt)
    got = fops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == tdt and got.shape == (b, hq, s, d)
    pallas = jkernel.flash_attention(jq, jk, jv, causal=causal, block_q=128, block_k=128)
    oracle = jref.mha(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_block_size_invariance(bq, bk):
    """The port takes no block sizes (its kernel picks its own tiles): its
    result is the Pallas kernel's at every block pair."""
    (jq, jk, jv), (q, k, v) = _inputs([(1, 2, 256, 64)] * 3, 3, jnp.float32, torch.float32)
    got = fops.flash_attention(q, k, v, causal=True)
    pallas = jkernel.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=1e-5)


@pytest.mark.parametrize("hkv,group", [(1, 1), (1, 4), (2, 2), (4, 2)])
def test_gqa_head_map(hkv, group):
    """Query head h reads kv head h // group, as the Pallas index map does."""
    shapes = [(2, hkv * group, 128, 32), (2, hkv, 128, 32), (2, hkv, 128, 32)]
    (jq, jk, jv), (q, k, v) = _inputs(shapes, 10 + hkv * group, jnp.float32, torch.float32)
    got = fops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(jkernel.flash_attention(jq, jk, jv, causal=True)),
                               atol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_mha_copies_ref_mha_with_unequal_lengths(causal):
    """The port's plain ``mha`` is the reference's, bottom-right causal
    alignment included (Sq = 128 queries against Skv = 256 keys)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        [(1, 4, 128, 32), (1, 2, 256, 32), (1, 2, 256, 32)], 4, jnp.float32, torch.float32)
    np.testing.assert_allclose(_np(fref.mha(q, k, v, causal=causal)),
                               _np(jref.mha(jq, jk, jv, causal=causal)), atol=2e-6)


@pytest.mark.parametrize("device", ["cpu", "meta"], ids=["plain_route", "kernel_route"])
def test_wrapper_raises_the_reference_errors(device):
    """The checks run before the route is chosen: a CPU tensor (the plain
    route) and a tensor of any other device (the kernel's) raise alike."""
    def t(*shape):
        return torch.zeros(shape, device=device)

    with pytest.raises(ValueError, match="Hq=6 not a multiple of Hkv=4"):
        fops.flash_attention(t(1, 6, 128, 32), t(1, 4, 128, 32), t(1, 4, 128, 32))
    with pytest.raises(ValueError, match=r"seq lens \(192,192\) must divide blocks \(128,128\)"):
        fops.flash_attention(t(1, 2, 192, 32), t(1, 2, 192, 32), t(1, 2, 192, 32))
    with pytest.raises(ValueError, match="Sq=128 != Skv=256"):
        fops.flash_attention(t(1, 2, 128, 32), t(1, 2, 256, 32), t(1, 2, 256, 32), causal=True)


def test_route_by_dtype_and_head_dim():
    """The CUDA kernel's route is a function of (dtype, head_dim) alone:
    bf16 at gemma-2b's 256 and at 64 and 128 takes TMA + wgmma, bf16 at
    16 and 32 mma.sync, float32 the CUDA cores; the rest raises with the
    wrapper's messages."""
    want = {16: "mma_sync", 32: "mma_sync", 64: "wgmma", 128: "wgmma", 256: "wgmma"}
    assert {d: fops.route(torch.bfloat16, d) for d in fops.BF16_HEAD_DIMS} == want
    assert {fops.route(torch.float32, d) for d in range(4, 257, 4)} == {"f32"}
    assert {r: rows for r, (_, rows) in fops.ROUTES.items()} == {
        "f32": 32, "mma_sync": 64, "wgmma": 128}
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        fops.route(torch.bfloat16, 48)
    with pytest.raises(ValueError, match="multiples of 4 up to 256"):
        fops.route(torch.float32, 258)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fops.route(torch.float16, 64)


def test_unequal_lengths_run_when_not_causal():
    (jq, jk, jv), (q, k, v) = _inputs(
        [(1, 4, 128, 32), (1, 2, 256, 32), (1, 2, 256, 32)], 5, jnp.float32, torch.float32)
    got = fops.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(
        _np(got), _np(jkernel.flash_attention(jq, jk, jv, causal=False)), atol=2e-5)


def test_backward_raises():
    """Forward only, like the reference's kernel (jax.grad through it
    raises): the LM trains through attention_chunked."""
    q = torch.randn(1, 2, 64, 16, requires_grad=True)
    k = torch.randn(1, 2, 64, 16)
    out = fops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no gradient"):
        out.sum().backward()


def test_attention_forward_refuses_a_window_on_the_kernel_route():
    """The reference's forward(use_flash_kernel=True) ignores ``window`` and
    attends to the whole sequence; the port raises instead."""
    from repro_torch.configs import gemma_2b

    cfg = gemma_2b.SMOKE
    params = tattn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(1, 32, cfg.d_model)
    with pytest.raises(ValueError, match="no sliding window"):
        tattn.forward(x, params, cfg, window=8, use_flash_kernel=True)
    assert tattn.forward(x, params, cfg, window=8).shape == x.shape  # the chunked route
