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
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth
from repro_torch.kernels.decode_utf8 import ops as dops
from repro_torch.kernels.decode_utf8 import ref as dref
from repro_torch.kernels.fused_vocab import ops as fvops
from repro_torch.kernels.fused_vocab import ref as fvref
from repro_torch.kernels.fused_xform import ops as fxops
from repro_torch.kernels.fused_xform import ref as fxref

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
