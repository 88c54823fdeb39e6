"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU with the CUDA toolkit and
skips without one. The file imports neither JAX nor tests/conftest.py, so
it also runs where JAX is not installed. On a machine with a card, from
the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full shapes.
"""

import numpy as np
import pytest
import torch
from chip_smoke import hostile_rows

from repro_torch.core import pipeline as P
from repro_torch.core import plan as tplan
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth
from repro_torch.kernels.decode_utf8 import ops as dops
from repro_torch.kernels.decode_utf8 import ref as dref
from repro_torch.kernels.dense_xform import ops as dxops
from repro_torch.kernels.dense_xform import ref as dxref
from repro_torch.kernels.fused_decode_vocab import ops as fdvops
from repro_torch.kernels.fused_decode_vocab import ref as fdvref
from repro_torch.kernels.fused_decode_xform import ops as fdxops
from repro_torch.kernels.fused_decode_xform import ref as fdxref
from repro_torch.kernels.fused_vocab import ops as fvops
from repro_torch.kernels.fused_vocab import ref as fvref
from repro_torch.kernels.fused_xform import ops as fxops
from repro_torch.kernels.fused_xform import ref as fxref
from repro_torch.kernels.vocab import ops as vops
from repro_torch.kernels.vocab import ref as vref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def criteo_small():
    cfg = synth.SynthConfig(rows=400, seed=42)
    buf, table = synth.make_dataset(cfg)
    return buf, table, cfg


def _hostile(seed, n_rows, truncate):
    raw = hostile_rows(np, seed, 13, 26, n_rows, truncate)
    return synth.pad_bytes(raw, 256)


def test_decode_kernel_matches_plain(cuda, criteo_small):
    hex_t = np.arange(40) >= 14
    bufs = [c for c in synth.chunk_stream(criteo_small[0], 4096)][:2]
    bufs += [_hostile(s, 30, s % 3) for s in range(6)]
    for max_rows in (8, 64):
        for buf in bufs:
            b = torch.from_numpy(buf).to(cuda)
            kw = dict(n_fields=40, max_rows=max_rows, n_dense=13, n_sparse=26)
            for g, w in zip(dops.decode(b, hex_t, **kw), dref.decode_bytes(b, hex_t, **kw)):
                assert torch.equal(g, w)


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("rows_seen", [0, tvocab.NEVER - 3], ids=["start", "ceiling"])
def test_genvocab_kernel_matches_plain(cuda, vocab_range, track_counts, rows_seen):
    rng = np.random.default_rng(vocab_range)
    sparse = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, size=(300, 26), dtype=np.int64).astype(np.int32)
    ).to(cuda)
    valid = torch.from_numpy(rng.random(300) < 0.8).to(cuda)

    def fresh():
        s = tvocab.VocabState.init(26, vocab_range, track_counts=track_counts, device=cuda)
        s.rows_seen.fill_(rows_seen)
        return s

    got = fvops.fused_update(fresh(), sparse, valid)
    want = fresh()
    seen = fvref.fused_genvocab(want.first_pos, want.counts, sparse, valid, want.rows_seen)
    assert torch.equal(got.first_pos, want.first_pos)
    assert torch.equal(got.rows_seen, seen)
    if track_counts:
        assert torch.equal(got.counts, want.counts)


@pytest.mark.parametrize("vocab_range", [257, 5000, 1_000_000])
def test_xform_kernels_match_plain(cuda, vocab_range):
    rng = np.random.default_rng(vocab_range)
    sparse = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, size=(300, 26), dtype=np.int64).astype(np.int32)
    ).to(cuda)
    dense = torch.from_numpy(rng.integers(-500, 10**6, size=(300, 13)).astype(np.int32)).to(cuda)
    table = torch.from_numpy(rng.integers(0, 1000, size=(26, vocab_range)).astype(np.int32))
    vocab = tvocab.Vocabulary(table=table.to(cuda), sizes=torch.zeros(26, dtype=torch.int32))
    ids, d = fxops.fused_transform(vocab, sparse, dense)
    ids_r, d_r = fxref.fused_transform(vocab.table, sparse, dense)
    assert torch.equal(ids, ids_r)
    torch.testing.assert_close(d, d_r, rtol=1e-6, atol=0)
    mod, d2 = fxops.fused_mod_dense(sparse, dense, vocab_range=vocab_range)
    assert torch.equal(mod, fxref.fused_mod_dense(sparse, dense, vocab_range)[0])
    torch.testing.assert_close(d2, d_r, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_pipeline_on_card_matches_cpu(cuda, criteo_small, fmt):
    buf, table, _ = criteo_small
    kw = dict(chunk_bytes=32768, max_rows_per_chunk=256, input_format=fmt)
    if fmt == "utf8":
        chunks = list(synth.chunk_stream(buf, 32768))
    else:
        chunks = [{k: table[k][i:i + 100] for k in ("label", "dense", "sparse")}
                  for i in range(0, 400, 100)]
    gpu = list(P.PiperPipeline(P.PipelineConfig(**kw)).run_stream(lambda: iter(chunks)))
    cpu = list(P.PiperPipeline(P.PipelineConfig(device="cpu", **kw))
               .run_stream(lambda: iter(chunks)))
    for g, c in zip(gpu, cpu):
        for f in ("label", "sparse", "valid"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f))
        torch.testing.assert_close(g.dense.cpu(), c.dense, rtol=1e-6, atol=0)


def _byte_chunks(criteo_small, cuda):
    """Two synth chunks and six hostile ones (every hostile class, fields
    longer than the 4 KiB tile, truncated final rows), at full width."""
    bufs = [c for c in synth.chunk_stream(criteo_small[0], 4096)][:2]
    bufs += [_hostile(s, 30, s % 3) for s in range(6)]
    return [torch.from_numpy(b).to(cuda) for b in bufs]


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("rows_seen", [0, tvocab.NEVER - 3], ids=["start", "ceiling"])
def test_fused_decode_vocab_kernel_matches_plain(cuda, criteo_small, vocab_range, rows_seen):
    """Bytes-in loop ①: first_pos and rows_seen bit for bit, into a state
    with some history, with max_rows below and above the chunks' rows."""
    rng = np.random.default_rng(vocab_range)
    history = torch.from_numpy(np.where(
        rng.random((26, vocab_range)) < 0.2, rng.integers(0, 50, (26, vocab_range)),
        tvocab.NEVER).astype(np.int32)).to(cuda)
    for max_rows in (8, 64):
        for buf in _byte_chunks(criteo_small, cuda):
            def fresh():
                return tvocab.VocabState(
                    history.clone(), torch.tensor(rows_seen, dtype=torch.int32, device=cuda))

            kw = dict(n_fields=40, hex_start=14, max_rows=max_rows)
            got = fdvops.fused_decode_update(fresh(), buf, **kw)
            want = fdvref.fused_decode_genvocab(fresh(), buf, **kw)
            assert torch.equal(got.first_pos, want.first_pos)
            assert torch.equal(got.rows_seen, want.rows_seen)


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
def test_fused_decode_xform_kernel_matches_plain(cuda, criteo_small, vocab_range):
    """Bytes-in loop ②: label, ids and valid bit for bit, dense at rtol
    1e-6, on every row, padding included."""
    rng = np.random.default_rng(vocab_range)
    table = torch.from_numpy(rng.integers(0, 1000, size=(26, vocab_range)).astype(np.int32))
    vocab = tvocab.Vocabulary(table=table.to(cuda), sizes=torch.zeros(26, dtype=torch.int32))
    for max_rows in (8, 64):
        for buf in _byte_chunks(criteo_small, cuda):
            kw = dict(n_fields=40, hex_start=14, max_rows=max_rows)
            got = fdxops.fused_decode_transform(vocab, buf, **kw)
            want = fdxref.fused_decode_transform(vocab, buf, **kw)
            for name, g, w in zip(("label", "dense", "ids", "valid"), got, want):
                if name == "dense":
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
                else:
                    assert torch.equal(g, w), name


@pytest.mark.parametrize("n_dense,n_sparse", [(0, 3), (3, 0), (2, 3)])
def test_fused_decode_degenerate_routes_match_plain(cuda, n_dense, n_sparse):
    """No dense or no sparse column, and an empty buffer: the wrappers'
    decode + decoded-input routes on the card give the plain results."""
    n_fields = 1 + n_dense + n_sparse
    rng = np.random.default_rng(n_fields)
    rows = ["\t".join([str(rng.integers(0, 2))]
                      + [str(rng.integers(-9, 999)) if rng.random() < 0.8 else ""
                         for _ in range(n_dense)]
                      + [f"{rng.integers(0, 2**32):x}" if rng.random() < 0.8 else ""
                         for _ in range(n_sparse)]) for _ in range(20)]
    raw = ("\n".join(rows) + "\n").encode()[:-5]  # the last row truncated
    bufs = [torch.from_numpy(synth.pad_bytes(raw, 64)).to(cuda),
            torch.zeros(0, dtype=torch.uint8, device=cuda)]
    vocab = tvocab.Vocabulary(
        table=torch.arange(n_sparse * 31, dtype=torch.int32, device=cuda).reshape(n_sparse, 31),
        sizes=torch.zeros(n_sparse, dtype=torch.int32))
    kw = dict(n_fields=n_fields, hex_start=1 + n_dense, max_rows=16)
    for buf in bufs:
        got = fdvops.fused_decode_update(tvocab.VocabState.init(n_sparse, 31, device=cuda),
                                         buf, **kw)
        want = fdvref.fused_decode_genvocab(tvocab.VocabState.init(n_sparse, 31, device=cuda),
                                            buf, **kw)
        assert torch.equal(got.first_pos, want.first_pos)
        assert torch.equal(got.rows_seen, want.rows_seen)
        for g, w in zip(fdxops.fused_decode_transform(vocab, buf, **kw),
                        fdxref.fused_decode_transform(vocab, buf, **kw)):
            assert torch.equal(g, w)


def test_bytes_in_pipeline_on_card_matches_cpu(cuda, criteo_small):
    """use_fused_decode=True on the card: one launch of each bytes-in kernel
    per chunk and no decode, and the same results as on the CPU."""
    buf = criteo_small[0]
    kw = dict(chunk_bytes=32768, max_rows_per_chunk=256, use_fused_decode=True)
    chunks = list(synth.chunk_stream(buf, 32768))
    pipe = P.PiperPipeline(P.PipelineConfig(**kw))
    for k in (dops.KERNEL, fdvops.KERNEL, fdxops.KERNEL):
        k.launches = 0
    gpu = list(pipe.run_stream(lambda: iter(chunks)))
    assert (dops.KERNEL.launches, fdvops.KERNEL.launches, fdxops.KERNEL.launches) == (
        0, len(chunks), len(chunks))
    cpu = list(P.PiperPipeline(P.PipelineConfig(device="cpu", **kw))
               .run_stream(lambda: iter(chunks)))
    scan = P.flatten_processed(pipe.run_scan(np.stack(chunks)))
    for f in ("label", "sparse", "valid"):
        assert torch.equal(getattr(scan, f), torch.cat([getattr(g, f) for g in gpu]))
    for g, c in zip(gpu, cpu):
        for f in ("label", "sparse", "valid"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f))
        torch.testing.assert_close(g.dense.cpu(), c.dense, rtol=1e-6, atol=0)


def _modded(rng, rows, n_cols, vocab_range, cuda):
    modded = rng.integers(0, vocab_range, size=(rows, n_cols)).astype(np.int32)
    modded[1::5] = modded[0]  # equal keys within the chunk min-combine
    return torch.from_numpy(modded).to(cuda)


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("rows_seen", [0, tvocab.NEVER - 3], ids=["start", "ceiling"])
def test_per_op_genvocab_kernel_matches_plain(cuda, vocab_range, track_counts, rows_seen):
    """kernels/vocab genvocab into a state with some history: first_pos,
    counts and rows_seen bit for bit, saturating at the ceiling."""
    rng = np.random.default_rng(vocab_range + 1)
    modded = _modded(rng, 300, 27, vocab_range, cuda)
    valid = torch.from_numpy(rng.random(300) < 0.8).to(cuda)
    history = torch.from_numpy(np.where(
        rng.random((27, vocab_range)) < 0.2, rng.integers(0, 50, (27, vocab_range)),
        tvocab.NEVER).astype(np.int32)).to(cuda)

    def fresh():
        counts = torch.ones_like(history) if track_counts else None
        return tvocab.VocabState(
            history.clone(), torch.tensor(rows_seen, dtype=torch.int32, device=cuda), counts)

    got = vops.genvocab_update(fresh(), modded, valid)
    want = fresh()
    pos = tvocab.positions(want.rows_seen, 300, valid)
    assert torch.equal(got.first_pos, vref.genvocab(want.first_pos, modded.t(), pos))
    assert torch.equal(got.rows_seen, tvocab.update(want, modded, valid).rows_seen)
    if track_counts:
        assert torch.equal(got.counts, vref.genvocab_counts(want.counts, modded.t(), pos))


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
def test_per_op_apply_vocab_kernel_matches_plain(cuda, vocab_range):
    rng = np.random.default_rng(vocab_range + 2)
    modded = _modded(rng, 300, 27, vocab_range, cuda)
    table = torch.from_numpy(
        rng.integers(0, 1000, size=(27, vocab_range)).astype(np.int32)).to(cuda)
    ids = vops.apply_vocab(table, modded)
    assert torch.equal(ids, vref.apply_vocab(table, modded.t()).t())
    assert torch.equal(ids, tvocab.lookup(tvocab.Vocabulary(table, None), modded))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_dense_transform_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(3)
    if dtype == "int32":
        x = rng.integers(-(2**31), 2**31 - 1, size=(1001, 13), dtype=np.int64).astype(np.int32)
        x[0, :6] = [-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1]
    else:
        x = (rng.standard_normal((1001, 13)) * 1e3).astype(np.float32)
        x[0, :7] = [-np.inf, -0.0, 0.0, 1e-30, 3.4e38, np.inf, np.nan]
    xt = torch.from_numpy(x).to(cuda)
    got = dxops.dense_transform(xt)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    torch.testing.assert_close(got, dxref.dense_transform(xt), rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_use_kernels_pipeline_on_card_matches_cpu(cuda, criteo_small, fmt):
    """The crossed plan with use_kernels=True and the fused hints off: per
    chunk one genvocab in loop ①, one apply_vocab and one dense_transform
    in loop ②, no fused kernel, and the CPU's results."""
    buf, table, _ = criteo_small
    kw = dict(chunk_bytes=32768, max_rows_per_chunk=256, input_format=fmt,
              plan=tplan.crossed_criteo(), use_kernels=True, use_fused_decode=True)
    if fmt == "utf8":
        chunks = list(synth.chunk_stream(buf, 32768))
    else:
        chunks = [{k: table[k][i:i + 100] for k in ("label", "dense", "sparse")}
                  for i in range(0, 400, 100)]
    counted = (vops.KERNEL_GENVOCAB, vops.KERNEL_APPLY, dxops.KERNEL, fvops.KERNEL,
               fvops.KERNEL_COUNTS, fxops.KERNEL, fdvops.KERNEL, fdxops.KERNEL)
    for k in counted:
        k.launches = 0
    gpu = list(P.PiperPipeline(P.PipelineConfig(
        use_fused_kernel=False, use_fused_vocab=False, **kw)).run_stream(lambda: iter(chunks)))
    n = len(chunks)
    assert [k.launches for k in counted] == [n, n, n, 0, 0, 0, 0, 0]
    cpu = list(P.PiperPipeline(P.PipelineConfig(device="cpu", **kw))
               .run_stream(lambda: iter(chunks)))
    for g, c in zip(gpu, cpu):
        assert g.sparse.shape[1] == 27
        for f in ("label", "sparse", "valid"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f))
        torch.testing.assert_close(g.dense.cpu(), c.dense, rtol=1e-6, atol=0)
