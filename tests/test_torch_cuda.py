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
from chip_smoke import decode_edge_chunks, hostile_rows

from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import piper_dlrm as tcfg
from repro_torch.core import pipeline as P
from repro_torch.core import plan as tplan
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth
from repro_torch.kernels.decode_utf8 import ops as dops
from repro_torch.kernels.decode_utf8 import ref as dref
from repro_torch.kernels.dense_xform import ops as dxops
from repro_torch.kernels.dense_xform import ref as dxref
from repro_torch.kernels.embedding_bag import ops as ebops
from repro_torch.kernels.embedding_bag import ref as ebref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
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
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train import tree as ttree
from repro_torch.train.tree import leaves

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


_EDGE_CHUNKS = {name: (arr, max_rows) for name, arr, max_rows in decode_edge_chunks(np)}
_CRITEO_HEX = np.arange(40) >= 14


def _decode_kw(max_rows):
    return dict(n_fields=40, max_rows=max_rows, n_dense=13, n_sparse=26)


def _assert_decodes_as_plain(buf, max_rows, calls=2):
    """``calls`` launches on ``buf``, each bit for bit the plain version's."""
    want = dref.decode_bytes(buf, _CRITEO_HEX, **_decode_kw(max_rows))
    for _ in range(calls):
        got = dops.decode(buf, _CRITEO_HEX, **_decode_kw(max_rows))
        for name, g, w in zip(("label", "dense", "sparse", "valid"), got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("name", list(_EDGE_CHUNKS))
def test_decode_single_pass_edge_chunks(cuda, name):
    """The single-pass kernel on each edge case of the tile scan (fields
    longer than two tiles, data that ends on a tile boundary and one byte
    past it, n of 0, 1 and 4097, dropped rows, rows of the wrong width, a
    truncated row, all padding), twice, bit for bit."""
    arr, max_rows = _EDGE_CHUNKS[name]
    _assert_decodes_as_plain(torch.from_numpy(arr).to(cuda), max_rows)


@pytest.mark.parametrize("offset", [0, 1, 7])
def test_decode_single_pass_synth_chunk_in_one_launch(cuda, offset):
    """A 1 MiB synth chunk at max_rows 16384 (also read from an address
    that is no multiple of 16): one wrapper launch per call, twice the
    plain version's bits."""
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=8000, seed=0))
    chunk = next(iter(synth.chunk_stream(buf, 1 << 20)))
    padded = torch.zeros(chunk.size + offset, dtype=torch.uint8, device=cuda)
    padded[offset:] = torch.from_numpy(chunk).to(cuda)
    b = padded[offset:]
    before = dops.KERNEL.launches
    _assert_decodes_as_plain(b, 1 << 14)
    assert dops.KERNEL.launches == before + 2


def test_decode_streams_keep_their_own_scratch(cuda):
    """Chunks back to back on two streams at once: each stream's calls use
    their own look-back scratch, and every result is the plain version's."""
    chunks = [torch.from_numpy(_EDGE_CHUNKS[n][0]).to(cuda)
              for n in ("truncated_row", "long_field_over_two_tiles", "ends_on_16384")]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            outs.append([dops.decode(c, _CRITEO_HEX, **_decode_kw(256)) for c in chunks * 3])
    torch.cuda.synchronize()
    handles = [st.cuda_stream for st in streams]
    sizes = [dops._scratch_ints(c.numel()) for c in chunks]
    assert dops.scan_scratch(cuda, handles[0], max(sizes)) is not dops.scan_scratch(
        cuda, handles[1], max(sizes))
    for per_stream in outs:
        for c, got in zip(chunks * 3, per_stream):
            want = dref.decode_bytes(c, _CRITEO_HEX, **_decode_kw(256))
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def _synth_chunk(size, rows=1 << 16):
    buf, _ = synth.make_dataset(synth.SynthConfig(rows=rows, seed=0))
    return next(iter(synth.chunk_stream(buf, size)))


@pytest.mark.parametrize("size", [2 << 20, 4 << 20], ids=["2MiB", "4MiB"])
def test_decode_single_pass_larger_chunks(cuda, size):
    """Chunks of more tiles than the card has SMs (2 and 4 MiB of synth
    rows at max_rows 16384, and the hostile chunks of 4136-byte fields),
    twice, bit for bit."""
    _assert_decodes_as_plain(torch.from_numpy(_synth_chunk(size)).to(cuda), 1 << 14)
    for seed, n_rows, max_rows in ((0, 3000, 2048), (1, 3000, 4096)):
        buf = _hostile(seed, n_rows, 7 * (seed == 0))
        _assert_decodes_as_plain(torch.from_numpy(buf).to(cuda), max_rows)


def test_decode_full_size_chunks_on_two_streams_at_once(cuda):
    """1 and 4 MiB chunks decoded on two streams at once, back to back:
    every launch ends (no block waits on one of another launch or on one
    that has not started) and every result is the plain version's."""
    chunks = [torch.from_numpy(_synth_chunk(size)).to(cuda) for size in (1 << 20, 4 << 20)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = [[], []]
    for _ in range(4):
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                outs[i] += [dops.decode(c, _CRITEO_HEX, **_decode_kw(1 << 14)) for c in chunks]
    torch.cuda.synchronize()
    wants = [dref.decode_bytes(c, _CRITEO_HEX, **_decode_kw(1 << 14)) for c in chunks]
    for per_stream in outs:
        for i, got in enumerate(per_stream):
            for g, w in zip(got, wants[i % 2]):
                assert torch.equal(g, w)


def test_decode_refuses_graph_capture(cuda):
    """A CUDA graph would replay one look-back epoch: capture raises."""
    buf = torch.from_numpy(_EDGE_CHUNKS["truncated_row"][0]).to(cuda)
    _assert_decodes_as_plain(buf, 256, calls=1)  # built and warmed up first
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            dops.decode(buf, _CRITEO_HEX, **_decode_kw(256))


def test_decode_epoch_wraps_without_a_stale_word(cuda):
    """Calls across the epoch's wrap (the scratch started three calls short
    of it): the wrap zeroes the status words, and every call still decodes
    bit for bit, chunks of different tile counts in turn."""
    chunks = [torch.from_numpy(_EDGE_CHUNKS[n][0]).to(cuda)
              for n in ("more_delims_than_cells", "ends_on_8192", "long_field_over_two_tiles")]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    scratch = dops.scan_scratch(cuda, stream, max(dops._scratch_ints(c.numel()) for c in chunks))
    scratch.epoch = dops.EPOCH_LIMIT - 3
    for i in range(8):
        c = chunks[i % 3]
        _assert_decodes_as_plain(c, 37 if i % 3 == 0 else 256, calls=1)
    assert scratch.epoch == 6  # two calls to the limit, then 1..6


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


def _zipf_chunk(rows, seed, hot_share=0.0):
    """Raw hashes [rows, 26] of the synth feed (Zipf(1.3) over 2^14 hashes a
    column); with ``hot_share``, that share of the cells holds one hash."""
    sparse = synth.generate_binary(synth.SynthConfig(rows=rows, seed=seed))["sparse"]
    if hot_share:
        rng = np.random.default_rng(seed)
        sparse[rng.random(sparse.shape) < hot_share] = 12345
    return sparse


@pytest.mark.parametrize("vocab_range", [5000, 1_000_000])
@pytest.mark.parametrize("state", ["fresh", "mixed"])
@pytest.mark.parametrize("rows_seen", [16384, tvocab.NEVER - 3], ids=["offset", "ceiling"])
@pytest.mark.parametrize("chunk", ["hot_quarter", "utf8_live_head", "all_invalid",
                                   "ragged_1001", "ragged_37_sparse_valid"])
def test_fused_genvocab_tiles_match_scatter_min(cuda, vocab_range, state, rows_seen, chunk):
    """The tiled kernel against the plain scatter_reduce_(amin), bit for bit:
    a [16384, 26] chunk where one hash fills a quarter of the cells (the
    warp merge), the utf8 shape (3745 live rows, padding after), an
    all-invalid chunk, and row counts that are no multiple of the tile;
    into a fresh state or one pre-filled with positions below and above the
    chunk's (so both the skipped and the issued atomics run)."""
    rng = np.random.default_rng(vocab_range + rows_seen % 1000)
    rows = {"ragged_1001": 1001, "ragged_37_sparse_valid": 37}.get(chunk, 16384)
    sparse = _zipf_chunk(rows, 3, hot_share=0.25 if chunk == "hot_quarter" else 0.0)
    valid = {"utf8_live_head": np.arange(rows) < 3745, "all_invalid": np.zeros(rows, bool),
             "ragged_37_sparse_valid": rng.random(rows) < 0.6}.get(chunk, np.ones(rows, bool))
    sparse[~valid] = 0
    first = np.full((26, vocab_range), tvocab.NEVER, np.int32)
    if state == "mixed":
        first = rng.integers(0, 3 * 16384, (26, vocab_range)).astype(np.int32)
        first[rng.random(first.shape) < 0.5] = tvocab.NEVER
    sparse, valid = torch.from_numpy(sparse).to(cuda), torch.from_numpy(valid).to(cuda)

    def fresh():
        return tvocab.VocabState(torch.from_numpy(first).to(cuda),
                                 torch.tensor(rows_seen, dtype=torch.int32, device=cuda))

    fvops.KERNEL.launches = 0
    got = fvops.fused_update(fresh(), sparse, valid)
    assert fvops.KERNEL.launches == 1
    want = fresh()
    seen = fvref.fused_genvocab(want.first_pos, None, sparse, valid, want.rows_seen)
    assert torch.equal(got.first_pos, want.first_pos)
    assert torch.equal(got.rows_seen, seen)
    # the tally is back at 0, so a second chunk counts from nothing
    assert int(fvops.tally(cuda, torch.cuda.current_stream(cuda).cuda_stream)) == 0


def test_fused_genvocab_streams_keep_their_own_tally(cuda):
    """Chunks on two streams at once: each stream's launches count into its
    own tally, and both states end as the plain version's."""
    sparse = torch.from_numpy(_zipf_chunk(16384, 4)).to(cuda)
    valid = torch.ones(16384, dtype=torch.bool, device=cuda)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    states, outs = [], []
    for i, st in enumerate(streams):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            s = tvocab.VocabState.init(26, 5000, device=cuda)
            s.rows_seen.fill_(i * 100)
            states.append(s)
            outs.append(fvops.fused_update(s, sparse, valid))
    torch.cuda.synchronize()
    assert fvops.tally(cuda, streams[0].cuda_stream) is not fvops.tally(
        cuda, streams[1].cuda_stream)
    for i, out in enumerate(outs):
        want = tvocab.VocabState.init(26, 5000, device=cuda)
        want.rows_seen.fill_(i * 100)
        seen = fvref.fused_genvocab(want.first_pos, None, sparse, valid, want.rows_seen)
        assert torch.equal(out.first_pos, want.first_pos)
        assert torch.equal(out.rows_seen, seen)


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


@pytest.mark.parametrize("vocab_range", [1, 2, 97, 4096, 5000, 1_000_000, 2**31 - 1])
@pytest.mark.parametrize("shape", ["4099x26+13", "37x3+0", "1x5+2", "offset_view"])
def test_fused_transform_edges_match_plain(cuda, vocab_range, shape):
    """The vectorised kernel and its fastmod at the divisor's edges (V = 1,
    a power of two, 2^31 - 1 with one column: an 8 GiB table), hashes at
    int32 min and max, -1 and V - 1, row counts that are no multiple of
    4, no dense columns, and rows read from an address that is no multiple
    of 16 (the scalar path); twice, ids bit for bit, dense at rtol 1e-6."""
    rows, n_sparse, n_dense = {"4099x26+13": (4099, 26, 13), "37x3+0": (37, 3, 0),
                               "1x5+2": (1, 5, 2), "offset_view": (301, 26, 13)}[shape]
    if vocab_range == 2**31 - 1:
        n_sparse = 1
    rng = np.random.default_rng(vocab_range % 997 + rows)
    sparse = rng.integers(-(2**31), 2**31, (rows + 1, n_sparse), dtype=np.int64)
    sparse.flat[:4] = [-(2**31), 2**31 - 1, -1, vocab_range - 1][: sparse.size]
    dense = rng.integers(-500, 10**6, (rows + 1, n_dense))
    sp = torch.from_numpy(sparse.astype(np.int32)).to(cuda)
    de = torch.from_numpy(dense.astype(np.int32)).to(cuda)
    sp, de = (sp[1:], de[1:]) if shape == "offset_view" else (sp[:rows], de[:rows])
    table = torch.randint(0, 2**31 - 1, (n_sparse, vocab_range), dtype=torch.int32, device=cuda)
    vocab = tvocab.Vocabulary(table=table, sizes=torch.zeros(n_sparse, dtype=torch.int32))
    ids_r, d_r = fxref.fused_transform(table, sp, de)
    mod_r = fxref.fused_mod_dense(sp, de, vocab_range)[0]
    for _ in range(2):
        ids, d = fxops.fused_transform(vocab, sp, de)
        assert torch.equal(ids, ids_r)
        torch.testing.assert_close(d, d_r, rtol=1e-6, atol=0)
        mod, d2 = fxops.fused_mod_dense(sp, de, vocab_range=vocab_range)
        assert torch.equal(mod, mod_r)
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


def _embedding_inputs(cuda, n_cols, vocab, dim, batch, seed=0, hot=0.3, out_of_range=False,
                      tables=True):
    """Tables (or None), ids and an output gradient on the card; a share
    ``hot`` of the rows of each column hold one id, so its run of equal ids
    spans many 32-row tiles of the gradient kernel (Zipf-like keys, as
    Piper's)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, n_cols)).astype(np.int32)
    ids[rng.random((batch, n_cols)) < hot] = vocab // 2
    if out_of_range and batch >= 2 and n_cols >= 3:
        ids[0, :3] = [-1, vocab, vocab + 7]
        ids[batch - 1, :3] = [-vocab - 3, 2 * vocab, -2]
    gen = torch.Generator(cuda).manual_seed(seed)
    t = torch.randn((n_cols, vocab, dim), generator=gen, device=cuda) if tables else None
    grad_out = torch.randn((batch, n_cols, dim), generator=gen, device=cuda)
    return t, torch.from_numpy(ids).to(cuda), grad_out


def _sum_bound(grad_out, ids, vocab):
    """|kernel − float64 sum| ≤ (n−1)·2^-24·Σ|terms| per element, n the most
    rows that add into one gradient row: the bound of any float32 order."""
    n = max(int(torch.unique(ebref.wrap_ids(ids[:, c], vocab), return_counts=True)[1].max())
            for c in range(ids.shape[1])) if ids.numel() else 1
    abs_sum = ebref.embedding_gather_backward(grad_out.abs(), ids, vocab, dtype=torch.float64)
    return abs_sum.mul_(max(n - 1, 1) * 2.0**-24)


@pytest.mark.parametrize("shape", [(26, 5000, 64, 4096), (26, 1_000_000, 64, 512),
                                   (3, 11, 5, 40), (4, 97, 8, 1), (2, 7, 64, 33)], ids=str)
@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_embedding_gather_kernel_bit_exact(cuda, shape, out_of_range):
    tables, ids, _ = _embedding_inputs(cuda, *shape, out_of_range=out_of_range)
    got = ebops.embedding_gather(tables, ids)
    assert got.shape == (shape[3], shape[0], shape[2]) and got.device == tables.device
    assert torch.equal(got, ebref.embedding_gather(tables, ids))


def test_embedding_gather_kernel_unaligned_takes_scalar_path(cuda):
    """A table 4 bytes off a 16-byte boundary gathers float by float."""
    _, ids, _ = _embedding_inputs(cuda, 3, 11, 8, 40)
    flat = torch.randn(3 * 11 * 8 + 1, device=cuda)
    tables = flat[1:].view(3, 11, 8)
    assert tables.data_ptr() % 16 == 4
    assert torch.equal(ebops.embedding_gather(tables, ids), ebref.embedding_gather(tables, ids))


@pytest.mark.parametrize("shape", [(26, 5000, 64, 4096), (26, 1_000_000, 64, 4096),
                                   (4, 50, 64, 5000), (3, 11, 5, 40), (2, 1, 8, 300),
                                   (4, 97, 8, 1), (2, 7, 64, 33), (3, 9, 4, 0),
                                   (26, 5000, 64, 4095), (26, 5000, 64, 4097),
                                   (26, 5000, 64, 16384), (26, 1_000_000, 64, 8192),
                                   (2, 8192, 6, 700), (3, 4096, 64, 9000)], ids=str)
@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_embedding_gather_backward_kernel_matches_float64(cuda, shape, out_of_range):
    """Against the plain gradient summed in float64, within the float32
    bound of ``_sum_bound``; ids out of range after the wrap add nothing;
    two launches on the same inputs give the same bits. (26, 5000, 64,
    16384) and (3, 4096, 64, 9000) sort in device memory (padded columns
    past 8192 rows), (2, 1, 8, 300) sums every row of a column into one
    table row, 4095 and 4097 rows end a segment early, (2, 8192, 6, 700)
    has a power-of-two table (the dropped key V needs one more bit) and
    rows of 6 floats, (3, 11, 5, 40) rows of 5 (one float a lane), and
    10^6 with 8192 rows no longer packs id and row into 32 bits."""
    n_cols, vocab, dim, batch = shape
    _, ids, grad_out = _embedding_inputs(cuda, *shape, seed=1, out_of_range=out_of_range,
                                         tables=False)
    got = ebops.embedding_gather_backward(grad_out, ids, vocab)
    again = ebops.embedding_gather_backward(grad_out, ids, vocab)
    assert got.shape == (n_cols, vocab, dim) and got.dtype == torch.float32
    assert torch.equal(got, again)
    del again  # at 1M each is 6.66 GB
    want = ebref.embedding_gather_backward(grad_out, ids, vocab, dtype=torch.float64)
    assert bool(((want == 0) <= (got == 0)).all())  # untouched rows stay exactly 0
    delta = got.double()
    del got
    delta.sub_(want).abs_()
    del want
    assert bool((delta <= _sum_bound(grad_out, ids, vocab)).all())


@pytest.mark.parametrize("batch", [32, 4096, 16384])
def test_embedding_gather_backward_one_id_per_column(cuda, batch):
    """Every row of each column holds one id, so its run spans every segment
    of the column: one warp joins the partials of all of them, in segment
    order, the same bits twice."""
    gen = torch.Generator(cuda).manual_seed(3)
    grad_out = torch.randn((batch, 4, 64), generator=gen, device=cuda)
    ids = torch.full((batch, 4), 17, dtype=torch.int32, device=cuda)
    ids[:, 3] = -1  # wraps to V - 1
    got = ebops.embedding_gather_backward(grad_out, ids, 5000)
    assert torch.equal(got, ebops.embedding_gather_backward(grad_out, ids, 5000))
    want = ebref.embedding_gather_backward(grad_out, ids, 5000, dtype=torch.float64)
    assert bool(((got.double() - want).abs() <= _sum_bound(grad_out, ids, 5000)).all())
    assert int((got != 0).any(-1).sum()) == 4


@pytest.mark.parametrize("vocab", [5000, 1_000_000])
def test_embedding_gather_backward_memset_route_matches(cuda, vocab):
    """The route that zeroes the gradient by cudaMemsetAsync gives the same
    bits as the one that zeroes it in the sort's launch."""
    _, ids, grad_out = _embedding_inputs(cuda, 26, vocab, 64, 4096, seed=2, out_of_range=True,
                                         tables=False)
    got = ebops.embedding_gather_backward(grad_out, ids, vocab)
    limit = ebops.ZERO_IN_KERNEL_MAX_BYTES
    ebops.ZERO_IN_KERNEL_MAX_BYTES = 2**62 if got.nbytes > limit else 0
    try:
        assert torch.equal(got, ebops.embedding_gather_backward(grad_out, ids, vocab))
    finally:
        ebops.ZERO_IN_KERNEL_MAX_BYTES = limit


def test_embedding_gather_autograd_launches_each_kernel_once(cuda):
    tables, ids, grad_out = _embedding_inputs(cuda, 26, 257, 16, 300)
    tables.requires_grad_()
    ebops.KERNEL.launches = ebops.KERNEL_BACKWARD.launches = 0
    out = ebops.embedding_gather(tables, ids)
    out.backward(grad_out)
    assert (ebops.KERNEL.launches, ebops.KERNEL_BACKWARD.launches) == (1, 1)
    want = ebref.embedding_gather_backward(grad_out, ids, 257, dtype=torch.float64)
    assert bool(((tables.grad.double() - want).abs() <= _sum_bound(grad_out, ids, 257)).all())


def test_embedding_wrappers_check_their_inputs(cuda):
    tables, ids, grad_out = _embedding_inputs(cuda, 3, 11, 8, 40)
    with pytest.raises(TypeError, match="int32"):
        ebops.embedding_gather(tables, ids.long())
    with pytest.raises(TypeError, match="float32"):
        ebops.embedding_gather(tables.double(), ids)
    with pytest.raises(ValueError, match="ids"):
        ebops.embedding_gather(tables, ids[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ebops.embedding_gather(tables, ids.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA tensor"):
        ebops.embedding_gather(tables, ids.cpu())
    with pytest.raises(ValueError, match="shape"):
        ebops.embedding_gather_backward(grad_out, ids[:-1].contiguous(), 11)
    with pytest.raises(TypeError, match="float32"):
        ebops.embedding_gather_backward(grad_out.double(), ids, 11)


def test_dlrm_train_step_on_card_matches_cpu(cuda):
    """One train step of SMOKE at full width on the card: one forward and
    one backward launch; the loss within rtol 1e-5 and every gradient within
    1e-5 of its largest entry of the same step on the CPU from the same
    weights (float32 sums in another order; TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tcfg.SMOKE.model
    gpu = tdlrm.DLRM(cfg, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    cpu = tdlrm.DLRM(cfg, device="cpu")
    with torch.no_grad():
        for a, b in zip(leaves(cpu.params_tree()), leaves(gpu.params_tree())):
            a.copy_(b.cpu())
    rng = np.random.default_rng(0)
    batch = {"dense": np.log1p(rng.integers(0, 3000, (512, 13))).astype(np.float32),
             "sparse": rng.integers(0, cfg.vocab_range, (512, 26)).astype(np.int32),
             "label": rng.integers(0, 2, 512).astype(np.int32)}
    gb = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    cb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_loss, want = tsteps.value_and_grad(tdlrm.loss, cpu, cb)
    ebops.KERNEL.launches = ebops.KERNEL_BACKWARD.launches = 0
    got_loss, got = tsteps.value_and_grad(tdlrm.loss, gpu, gb)
    assert (ebops.KERNEL.launches, ebops.KERNEL_BACKWARD.launches) == (1, 1)
    torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=1e-5, atol=0)
    for g, w in zip(leaves(got), leaves(want)):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())
    step = tsteps.make_tabular_train_step(tdlrm.loss, topt.AdamWConfig())
    state = topt.adamw_init(gpu.params_tree())
    metrics = step(gpu, state, gb)
    assert all(v.device.type == "cuda" and bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state["step"]) == 1


# --------------------------------------------------------------------- #
# flash attention (csrc/flash_attention.cu)
# --------------------------------------------------------------------- #
def _qkv(shape_q, shape_kv, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 8, 1, 256, 128), (2, 2, 2, 512, 32),
    (2, 4, 1, 64, 16), (1, 8, 1, 96, 256), (1, 2, 2, 48, 256),
    (1, 8, 1, 1024, 256), (2, 8, 1, 384, 256), (1, 8, 1, 64, 256), (1, 4, 4, 512, 128)])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, dtype, tol):
    """The reference's tolerances (tests/test_kernels_flash.py): the float32
    kernel sums in another order than the plain float32 product, the bf16
    kernels round P to bf16 before P·V. Ragged last tiles (96, 48 rows)
    are masked inside the kernel. On the bf16 wgmma route (D 64, 128, 256):
    1024 rows wrap the ring of K/V stages many times; 384 rows are an odd
    number of 128-row blocks, with diagonal tiles in both consumer
    warpgroups; 64 rows are one partial block, filled by TMA's
    out-of-bounds zeros."""
    q, k, v = _qkv((b, hq, s, d), (b, hkv, s, d), dtype, 0, cuda)
    fops.KERNEL.launches = 0
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.KERNEL.launches == 1 and got.dtype == dtype
    want = fref.mha(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_kernel_reads_strided_head_views(cuda, d, dtype, tol):
    """k and v as the attention layer hands them over: [B, S, H, D] viewed
    as [B, H, S, D], read through their strides with no copy (on the wgmma
    route, through the tensor maps' strides); and a non-causal call with
    Sq != Skv."""
    b, s, hq, hkv = 2, 256, 4, 2
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((b, s, hq + 2 * hkv, d)).astype(np.float32))
    qkv = qkv.to(cuda, dtype)
    q, k, v = (qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    assert not k.is_contiguous()
    got = fops.flash_attention(q, k, v, causal=True)
    want = fref.mha(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    got = fops.flash_attention(q[:, :, :128], k, v, causal=False)
    want = fref.mha(q[:, :, :128], k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 16, "mma_sync"), (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 4, "f32"), (torch.float32, 64, "f32"),
    (torch.float32, 256, "f32")])
def test_flash_route_pins_each_head_dim(cuda, dtype, d, route):
    """ops.route names the kernel each (dtype, head_dim) takes on the card,
    and the call launches it exactly once."""
    assert fops.route(dtype, d) == route
    q, k, v = _qkv((1, 2, 128, d), (1, 1, 128, d), dtype, 3, cuda)
    fops.KERNEL.launches = 0
    got = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fops.KERNEL.launches == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fref.mha(q, k, v).float(), atol=tol, rtol=tol)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 64, 48), (1, 2, 64, 48), torch.bfloat16, 2, cuda)
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        fops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 64, 64), (1, 2, 64, 64), torch.float16, 2, cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fops.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 64, 64), (1, 2, 64, 64), torch.float32, 2, cuda)
    odd_rows = torch.zeros((1, 2, 64, 65), device=cuda)[..., :64]  # rows 260 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        fops.flash_attention(q, odd_rows, v)
    with pytest.raises(ValueError, match="Sq=64 != Skv=128"):
        fops.flash_attention(q, torch.cat([k, k], 2), torch.cat([v, v], 2), causal=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        qg = q.clone().requires_grad_(True)
        fops.flash_attention(qg, k, v).sum().backward()
    # no fallback: a tensor map TMA refuses (a row stride of 2^40 bytes)
    # raises, and nothing is launched or counted
    q, k, v = _qkv((1, 2, 128, 256), (1, 1, 128, 256), torch.bfloat16, 2, cuda)
    out = torch.empty_like(q)
    p, launches = fops._build.ptr, fops.KERNEL.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        fops.KERNEL.launch(cuda, p(q), p(k), p(v), p(out), *q.stride()[:2], 2**39,
                           *k.stride()[:3], *v.stride()[:3], 1, 2, 1, 128, 128, 256, 1,
                           fops.ROUTES["wgmma"][0])
    assert fops.KERNEL.launches == launches


def test_lm_smoke_prefill_on_card_matches_cpu(cuda):
    """gemma-2b SMOKE (head_dim 16, MQA) prefill through the kernel on the
    card against the chunked route on the CPU from the same weights, in
    float32 compute (summation order only: 1e-4 of the logits' scale)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tgemma.SMOKE
    cpu_model = tlm.LM(cfg, attn_impl="chunked", device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card_model = tlm.LM(cfg, attn_impl="flash", device=cuda)
    card_params = ttree.tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64),
                                                                dtype=np.int32))
    want = tsteps.make_prefill_step(cpu_model)(params, {"tokens": tokens},
                                               compute_dtype=torch.float32)
    fops.KERNEL.launches = 0
    got = tsteps.make_prefill_step(card_model)(card_params, {"tokens": tokens.to(cuda)},
                                               compute_dtype=torch.float32)
    assert fops.KERNEL.launches == cfg.n_layers
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
