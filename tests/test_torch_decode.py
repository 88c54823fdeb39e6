"""The port's decode (repro_torch.kernels.decode_utf8) against the JAX
package's reference scan and its Pallas kernel (interpret mode), on synth
chunks and the decode fuzzer's hostile chunks, full arrays compared. On
the CPU ``ops.decode`` takes the plain version; the CUDA kernel is held to
it in tests/test_torch_cuda.py and on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_utf8 import ops as jdops
from repro.kernels.decode_utf8 import ref as jdref
from repro_torch.kernels import _scratch
from repro_torch.kernels.decode_utf8 import ops as tdops
from repro_torch.kernels.decode_utf8 import ref as tdref
from tests.test_decode_fuzz import _hostile_chunk

N_DENSE, N_SPARSE = 13, 26
N_FIELDS = 1 + N_DENSE + N_SPARSE


def _kw(max_rows, n_dense=N_DENSE, n_sparse=N_SPARSE):
    return dict(n_fields=1 + n_dense + n_sparse, max_rows=max_rows, n_dense=n_dense,
                n_sparse=n_sparse)


def _hex_table(n_dense=N_DENSE, n_sparse=N_SPARSE):
    return np.arange(1 + n_dense + n_sparse) >= 1 + n_dense


def _assert_same(got, want, what):
    for name, g, w in zip(("label", "dense", "sparse", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what}: {name}")


def _both(buf, max_rows, pallas: bool, **schema):
    """Port decode vs the reference scan (and the Pallas kernel)."""
    kw = _kw(max_rows, **schema)
    hex_t = _hex_table(**schema)
    got = tdops.decode(torch.from_numpy(buf), hex_t, **kw)
    _assert_same(got, jdref.decode_bytes(jnp.asarray(buf), jnp.asarray(hex_t), **kw), "ref")
    if pallas:  # the Pallas kernel takes whole 2048-byte tiles
        padded = np.pad(buf, (0, (-len(buf)) % 2048))
        _assert_same(got, jdops.decode(jnp.asarray(padded), jnp.asarray(hex_t), **kw), "pallas")


@pytest.mark.parametrize("max_rows", [8, 64], ids=["drop-rows", "all-rows"])
def test_synth_chunks(criteo_small, max_rows):
    from repro.data import synth

    chunks = list(synth.chunk_stream(criteo_small[0], 4096))
    for i, chunk in enumerate(chunks[:3]):
        _both(chunk, max_rows, pallas=i == 0)


@pytest.mark.parametrize(
    "seed,n_rows,truncate,max_rows",
    [(0, 12, 0, 8), (1, 20, 5, 16), (2, 9, 1, 32), (3, 16, 40, 12)],
)
def test_hostile_chunks(seed, n_rows, truncate, max_rows):
    """Empty, all-delimiter, invalid/overlong hex, overlong decimal,
    stray-minus and tile-straddling rows, truncated final rows, and more
    rows than ``max_rows``."""
    buf = _hostile_chunk(seed, N_DENSE, N_SPARSE, n_rows, truncate)
    _both(buf, max_rows, pallas=seed < 2)


def test_small_schema_and_edge_buffers():
    sch = dict(n_dense=2, n_sparse=3)
    for seed in range(3):
        _both(_hostile_chunk(seed, 2, 3, 30, seed), 16, pallas=False, **sch)
    for raw in (b"", b"\n", b"\t\t\t\t\t\n", b"-\t-5\tff\tFF\t1g\n", b"1\t2\t3"):
        _both(np.frombuffer(raw, np.uint8).copy(), 4, pallas=False, **sch)


def test_ref_handles_permuted_layout():
    """The plain version decodes any layout; the kernel wrapper refuses a
    permuted one, as the reference's wrapper does."""
    buf = _hostile_chunk(4, 2, 3, 10, 0)
    hex_t = np.array([False, True, False, True, False, True])
    kw = _kw(16, 2, 3)
    got = tdref.decode_bytes(torch.from_numpy(buf), hex_t, **kw)
    _assert_same(got, jdref.decode_bytes(jnp.asarray(buf), jnp.asarray(hex_t), **kw), "ref")
    with pytest.raises(ValueError, match="contiguous decimal-then-hex"):
        tdops.decode(torch.from_numpy(buf), hex_t, **kw)
    with pytest.raises(ValueError, match="contiguous decimal-then-hex"):
        tdops.decode(torch.from_numpy(buf), torch.from_numpy(hex_t), **kw)


# -- the kernel's look-back scratch (host side; the card tests run it) ----- #
def test_scan_scratch_epochs_count_from_one_and_wrap_with_a_zeroing():
    s = _scratch.ScanScratch(16, torch.device("cpu"))
    assert s.words.dtype == torch.int32 and not s.words.any()
    assert [s.next_epoch() for _ in range(3)] == [1, 2, 3]
    s.words.fill_(7)  # status words of earlier calls
    s.epoch = _scratch.EPOCH_LIMIT - 2
    assert s.next_epoch() == _scratch.EPOCH_LIMIT - 1
    assert s.words.eq(7).all()
    assert s.next_epoch() == 1  # the epochs ran out: the words are zeroed
    assert not s.words.any()
    assert s.next_epoch() == 2


def test_scan_scratch_is_kept_per_stream_and_grows_zeroed():
    dev = torch.device("cpu")
    a = _scratch.scan_scratch(dev, 111, 40)
    a.next_epoch()
    assert _scratch.scan_scratch(dev, 111, 40) is a  # kept, epoch and all
    assert _scratch.scan_scratch(dev, 111, 12) is a
    assert _scratch.scan_scratch(dev, 222, 40) is not a  # another stream
    a.words.fill_(3)
    b = _scratch.scan_scratch(dev, 111, 41)  # a larger chunk: new words, zeroed
    assert b is not a and b.words.numel() == 41 and not b.words.any() and b.epoch == 0
    assert _scratch.scan_scratch(dev, 111, 41) is b
