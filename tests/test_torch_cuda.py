"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU with the CUDA toolkit and
skips without one. The file imports neither JAX nor tests/conftest.py, so
it also runs where JAX is not installed. On a machine with a card, from
the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full shapes.
"""

import dataclasses
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from chip_smoke import decode_edge_chunks, device_kernels, hostile_rows

from repro_torch import configs as tconfigs
from repro_torch import interop as tinterop
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import piper_dlrm as tcfg
from repro_torch.core import pipeline as P
from repro_torch.core import plan as tplan
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import _scratch
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
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import ssm as tssm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train import trainer as ttrainer
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
    sizes = [_scratch.scratch_ints(c.numel()) for c in chunks]
    assert _scratch.scan_scratch(cuda, handles[0], max(sizes)) is not _scratch.scan_scratch(
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
    scratch = _scratch.scan_scratch(cuda, stream, max(_scratch.scratch_ints(c.numel()) for c in chunks))
    scratch.epoch = _scratch.EPOCH_LIMIT - 3
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
    assert int(_scratch.tally(cuda, torch.cuda.current_stream(cuda).cuda_stream)) == 0


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
    assert _scratch.tally(cuda, streams[0].cuda_stream) is not _scratch.tally(
        cuda, streams[1].cuda_stream)
    for i, out in enumerate(outs):
        want = tvocab.VocabState.init(26, 5000, device=cuda)
        want.rows_seen.fill_(i * 100)
        seen = fvref.fused_genvocab(want.first_pos, None, sparse, valid, want.rows_seen)
        assert torch.equal(out.first_pos, want.first_pos)
        assert torch.equal(out.rows_seen, seen)


# case → (rows, columns, valid rows, share of cells that hold one hash)
_COUNTS_CASES = {
    "hot_quarter": (16384, 26, "all", 0.25),
    "rows_1": (1, 26, "all", 0.0),
    "rows_31": (31, 26, "all", 0.0),
    "rows_33": (33, 26, "scattered", 0.0),
    "rows_4099": (4099, 26, "scattered", 0.0),
    "40_columns": (4099, 40, "scattered", 0.0),
    "no_prefix_valid": (16384, 26, "scattered", 0.0),
    "all_invalid": (16384, 26, "none", 0.0),
}


@pytest.mark.parametrize("vocab_range", [1, 97, 5000, 1_000_000])
@pytest.mark.parametrize("rows_seen", [16384, tvocab.NEVER - 3], ids=["offset", "ceiling"])
@pytest.mark.parametrize("case", list(_COUNTS_CASES))
def test_fused_genvocab_counts_match_plain(cuda, vocab_range, rows_seen, case):
    """fused_genvocab_counts (the warp-per-column kernel with the count
    plane) bit for bit on first_pos, counts and rows_seen against its plain
    version: a Zipf chunk where one hash fills a quarter of the cells (the
    hot slot's count grows by exactly its live rows), 1, 31, 33 and 4099
    rows, 40 columns (more than 32 warps), valid rows that are no prefix,
    no valid row; into a state with history (positions below and above the
    chunk's, counts 0-8), at an offset and three rows below the ceiling,
    where the counts stop with the positions."""
    rows, n_cols, kind, hot = _COUNTS_CASES[case]
    rng = np.random.default_rng(rows + n_cols + vocab_range % 1000)
    sparse = _zipf_chunk(rows, 5, hot_share=hot)
    if n_cols > sparse.shape[1]:
        sparse = np.ascontiguousarray(np.concatenate([sparse, sparse[::-1, :n_cols - 26]], 1))
    valid = {"all": np.ones(rows, bool), "none": np.zeros(rows, bool),
             "scattered": rng.random(rows) < 0.6}[kind]
    if kind == "scattered":
        valid[0] = False  # no prefix
    first = rng.integers(0, 3 * 16384, (n_cols, vocab_range)).astype(np.int32)
    first[rng.random(first.shape) < 0.5] = tvocab.NEVER
    counts = rng.integers(0, 9, (n_cols, vocab_range)).astype(np.int32)
    sp, v = torch.from_numpy(sparse).to(cuda), torch.from_numpy(valid).to(cuda)

    def fresh():
        return tvocab.VocabState(torch.tensor(first, device=cuda),
                                 torch.tensor(rows_seen, dtype=torch.int32, device=cuda),
                                 torch.tensor(counts, device=cuda))

    fvops.KERNEL_COUNTS.launches = 0
    got = fvops.fused_update(fresh(), sp, v)
    assert fvops.KERNEL_COUNTS.launches == 1
    want = fresh()
    seen = fvref.fused_genvocab(want.first_pos, want.counts, sp, v, want.rows_seen)
    assert torch.equal(got.first_pos, want.first_pos)
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.rows_seen, seen)
    if case == "hot_quarter" and rows_seen == 16384:  # every row live
        slot = 12345 % vocab_range
        hits = (sparse.view(np.uint32).astype(np.int64) % vocab_range == slot).sum(0)
        assert hits.min() > rows // 5
        np.testing.assert_array_equal(got.counts[:, slot].cpu().numpy() - counts[:, slot], hits)
    assert int(_scratch.tally(cuda, torch.cuda.current_stream(cuda).cuda_stream)) == 0


def test_fused_genvocab_counts_streams_keep_their_own_tally(cuda):
    """Chunks with counts on two streams at once, each into its own state:
    each stream counts into its own tally, and both states end as the
    plain version's."""
    sparse = torch.from_numpy(_zipf_chunk(16384, 4)).to(cuda)
    valid = torch.from_numpy(np.random.default_rng(4).random(16384) < 0.7).to(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for i, st in enumerate(streams):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            s = tvocab.VocabState.init(26, 1_000_000 if i else 5000, track_counts=True,
                                       device=cuda)
            s.rows_seen.fill_(i * 100)
            outs.append(fvops.fused_update(s, sparse, valid))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        want = tvocab.VocabState.init(26, 1_000_000 if i else 5000, track_counts=True,
                                      device=cuda)
        want.rows_seen.fill_(i * 100)
        seen = fvref.fused_genvocab(want.first_pos, want.counts, sparse, valid, want.rows_seen)
        assert torch.equal(out.first_pos, want.first_pos)
        assert torch.equal(out.counts, want.counts)
        assert torch.equal(out.rows_seen, seen)


def test_fused_genvocab_counts_is_one_kernel_a_call(cuda):
    """One wrapper call is one launch of genvocab_warp_kernel<ModSlot,
    true> and no other device work."""
    sparse = torch.from_numpy(_zipf_chunk(16384, 6)).to(cuda)
    valid = torch.arange(16384, device=cuda) < 3745
    state = tvocab.VocabState.init(26, 5000, track_counts=True, device=cuda)
    found = device_kernels(torch, lambda: fvops.fused_update(state, sparse, valid))
    assert list(found.values()) == [5], found
    name = next(iter(found))
    assert "genvocab_warp_kernel" in name and "ModSlot" in name and "true" in name, name


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
    longer than the 256-byte halo, truncated final rows), at full width."""
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


def _table(n_sparse, vocab_range, seed, cuda):
    gen = torch.Generator(cuda).manual_seed(seed)
    table = torch.randint(0, 2**31 - 1, (n_sparse, vocab_range), generator=gen,
                          dtype=torch.int32, device=cuda)
    return tvocab.Vocabulary(table=table, sizes=torch.zeros(n_sparse, dtype=torch.int32))


def _assert_xform_as_plain(buf, max_rows, vocab, calls=2):
    """``calls`` launches of the bytes-in loop-② kernel on ``buf``, each the
    plain version's: label, ids and valid bit for bit, dense at rtol 1e-6.
    Every call but the empty buffer's (decode's route) is one launch."""
    kw = dict(n_fields=40, hex_start=14, max_rows=max_rows)
    want = fdxref.fused_decode_transform(vocab, buf, **kw)
    for _ in range(calls):
        before = fdxops.KERNEL.launches
        got = fdxops.fused_decode_transform(vocab, buf, **kw)
        assert fdxops.KERNEL.launches == before + (buf.numel() > 0)
        for name, g, w in zip(("label", "dense", "ids", "valid"), got, want):
            if name == "dense":
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
            else:
                assert torch.equal(g, w), name


@pytest.mark.parametrize("vocab_range", [1, 97, 5000, 1_000_000])
@pytest.mark.parametrize("name", list(_EDGE_CHUNKS))
def test_fused_decode_xform_single_pass_edge_chunks(cuda, name, vocab_range):
    """The one-launch bytes-in loop ② on each edge case of the tile scan
    (data that ends on an 8 KiB tile boundary and one byte past it, n of 1
    and 8193, a field longer than the 256-byte halo across the tile
    boundary, a truncated row, all padding, more delimiters than cells),
    twice: padding cells get the transform of a zero field (ids
    table[c, 0])."""
    arr, max_rows = _EDGE_CHUNKS[name]
    vocab = _table(26, vocab_range, vocab_range, cuda)
    _assert_xform_as_plain(torch.from_numpy(arr).to(cuda), max_rows, vocab)


@pytest.mark.parametrize("vocab_range", [5000, 1_000_000])
def test_fused_decode_xform_single_pass_larger_chunks(cuda, vocab_range):
    """The synth 1 MiB chunk at max_rows 16384 and at 1000 (below its
    rows), 2 and 4 MiB chunks, and the hostile chunks of 4136-byte fields
    (longer than the halo, read by one thread from device memory)."""
    vocab = _table(26, vocab_range, 3, cuda)
    for size, max_rows in ((1 << 20, 1 << 14), (1 << 20, 1000), (2 << 20, 1 << 14),
                           (4 << 20, 1 << 14)):
        buf = torch.from_numpy(_synth_chunk(size)).to(cuda)
        _assert_xform_as_plain(buf, max_rows, vocab)
    for seed, n_rows, max_rows in ((0, 3000, 2048), (1, 3000, 4096)):
        buf = _hostile(seed, n_rows, 7 * (seed == 0))
        _assert_xform_as_plain(torch.from_numpy(buf).to(cuda), max_rows, vocab)


def test_fused_decode_xform_shares_decode_scratch_across_an_epoch_wrap(cuda):
    """Bytes-in loop ② and decode in turn on one stream, across the epoch's
    wrap: they share the stream's look-back scratch, each call takes the
    next epoch, and every result is the plain version's."""
    vocab = _table(26, 97, 1, cuda)
    chunks = [torch.from_numpy(_EDGE_CHUNKS[n][0]).to(cuda)
              for n in ("more_delims_than_cells", "ends_on_8192", "field_over_halo_across_8192")]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _assert_xform_as_plain(chunks[0], 37, vocab, calls=1)  # built and warmed up first
    scratch = _scratch.scan_scratch(cuda, stream, max(_scratch.scratch_ints(c.numel()) for c in chunks))
    scratch.epoch = _scratch.EPOCH_LIMIT - 3
    for i in range(8):
        c, max_rows = chunks[i % 3], 37 if i % 3 == 0 else 256
        if i % 2:
            _assert_decodes_as_plain(c, max_rows, calls=1)
        else:
            _assert_xform_as_plain(c, max_rows, vocab, calls=1)
    assert _scratch.scan_scratch(cuda, stream, 0) is scratch
    assert scratch.epoch == 6  # two calls to the limit, then 1..6


def test_fused_decode_xform_on_two_streams_at_once(cuda):
    """1 and 4 MiB chunks through bytes-in loop ② and decode on two streams
    at once, back to back: every launch ends and every result is the plain
    version's."""
    vocab = _table(26, 5000, 2, cuda)
    chunks = [torch.from_numpy(_synth_chunk(size)).to(cuda) for size in (1 << 20, 4 << 20)]
    kw = dict(n_fields=40, hex_start=14, max_rows=1 << 14)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = [[], []]
    for _ in range(3):
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                for c in chunks:
                    outs[i].append(fdxops.fused_decode_transform(vocab, c, **kw))
                    dops.decode(c, _CRITEO_HEX, **_decode_kw(1 << 14))
    torch.cuda.synchronize()
    wants = [fdxref.fused_decode_transform(vocab, c, **kw) for c in chunks]
    for per_stream in outs:
        for i, got in enumerate(per_stream):
            for name, g, w in zip(("label", "dense", "ids", "valid"), got, wants[i % 2]):
                if name == "dense":
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
                else:
                    assert torch.equal(g, w), name


def test_fused_decode_xform_refuses_graph_capture(cuda):
    """A CUDA graph would replay one look-back epoch: capture raises."""
    vocab = _table(26, 97, 4, cuda)
    buf = torch.from_numpy(_EDGE_CHUNKS["truncated_row"][0]).to(cuda)
    _assert_xform_as_plain(buf, 256, vocab, calls=1)  # built and warmed up first
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            fdxops.fused_decode_transform(vocab, buf, n_fields=40, hex_start=14, max_rows=256)


def test_fused_decode_xform_is_one_kernel_a_call(cuda):
    """The profiler sees one device kernel per call of bytes-in loop ② on
    the synth 1 MiB chunk, and nothing else."""
    vocab = _table(26, 5000, 5, cuda)
    buf = torch.from_numpy(_synth_chunk(1 << 20)).to(cuda)
    found = device_kernels(torch, lambda: fdxops.fused_decode_transform(
        vocab, buf, n_fields=40, hex_start=14, max_rows=1 << 14))
    assert list(found.values()) == [5], found


def _history(vocab_range, seed, cuda, n_cols=26):
    """A loop-① state's first positions with some history: a fifth of the
    slots below 50, the rest NEVER."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.where(
        rng.random((n_cols, vocab_range)) < 0.2, rng.integers(0, 50, (n_cols, vocab_range)),
        tvocab.NEVER).astype(np.int32)).to(cuda)


def _assert_vocab_as_plain(buf, max_rows, history, rows_seen=0, calls=2):
    """``calls`` launches of the bytes-in loop-① kernel on ``buf``, each into
    a copy of ``history`` at ``rows_seen``: first_pos and rows_seen bit for
    bit the plain version's. Every call but the empty buffer's (decode's
    route) is one launch."""
    kw = dict(n_fields=40, hex_start=14, max_rows=max_rows)

    def fresh():
        return tvocab.VocabState(history.clone(),
                                 torch.tensor(rows_seen, dtype=torch.int32, device=history.device))

    want = fdvref.fused_decode_genvocab(fresh(), buf, **kw)
    for _ in range(calls):
        before = fdvops.KERNEL.launches
        got = fdvops.fused_decode_update(fresh(), buf, **kw)
        assert fdvops.KERNEL.launches == before + (buf.numel() > 0)
        assert torch.equal(got.first_pos, want.first_pos)
        assert torch.equal(got.rows_seen, want.rows_seen)


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("name", list(_EDGE_CHUNKS))
def test_fused_decode_vocab_single_pass_edge_chunks(cuda, name, vocab_range):
    """The one-launch bytes-in loop ① on each edge case of the tile scan
    (the decode's, and rows the tiles cannot count from their own
    newlines: rows three fields long, max_rows cutting a tile, short rows
    whose missing fields lie past the last delimiter), twice, into a
    state with history."""
    arr, max_rows = _EDGE_CHUNKS[name]
    _assert_vocab_as_plain(torch.from_numpy(arr).to(cuda), max_rows,
                           _history(vocab_range, vocab_range, cuda))


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("rows_seen", [0, tvocab.NEVER - 3], ids=["start", "ceiling"])
def test_fused_decode_vocab_single_pass_larger_chunks(cuda, vocab_range, rows_seen):
    """The synth 1 MiB chunk at max_rows 16384 and 1000 (below its rows),
    2 and 4 MiB chunks (a row straddles every tile boundary), and the
    hostile chunks of 4136-byte fields, into a state with history, at the
    state's start and three rows below the ceiling."""
    history = _history(vocab_range, 3, cuda)
    for size, max_rows in ((1 << 20, 1 << 14), (1 << 20, 1000), (2 << 20, 1 << 14),
                           (4 << 20, 1 << 14)):
        buf = torch.from_numpy(_synth_chunk(size)).to(cuda)
        _assert_vocab_as_plain(buf, max_rows, history, rows_seen)
    for seed, n_rows, max_rows in ((0, 3000, 2048), (1, 3000, 4096)):
        buf = _hostile(seed, n_rows, 7 * (seed == 0))
        _assert_vocab_as_plain(torch.from_numpy(buf).to(cuda), max_rows, history, rows_seen)


def test_fused_decode_vocab_shares_decode_scratch_across_an_epoch_wrap(cuda):
    """Bytes-in loops ① and ② and decode in turn on one stream, across the
    epoch's wrap: they share the stream's look-back scratch, each call
    takes the next epoch, and every result is the plain version's."""
    vocab = _table(26, 97, 1, cuda)
    history = _history(97, 1, cuda)
    chunks = [(torch.from_numpy(_EDGE_CHUNKS[n][0]).to(cuda), _EDGE_CHUNKS[n][1])
              for n in ("more_delims_than_cells", "long_rows_over_4_tiles",
                        "field_over_halo_across_8192", "short_rows_over_4_tiles")]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _assert_vocab_as_plain(*chunks[0], history, calls=1)  # built and warmed up first
    scratch = _scratch.scan_scratch(
        cuda, stream, max(_scratch.scratch_ints(c.numel()) for c, _ in chunks))
    scratch.epoch = _scratch.EPOCH_LIMIT - 3
    for i in range(9):
        c, max_rows = chunks[i % 4]
        if i % 3 == 0:
            _assert_vocab_as_plain(c, max_rows, history, calls=1)
        elif i % 3 == 1:
            _assert_decodes_as_plain(c, max_rows, calls=1)
        else:
            _assert_xform_as_plain(c, max_rows, vocab, calls=1)
    assert _scratch.scan_scratch(cuda, stream, 0) is scratch
    assert scratch.epoch == 7  # two calls to the limit, then 1..7


def test_fused_decode_vocab_on_two_streams_at_once(cuda):
    """1 and 4 MiB chunks through bytes-in loop ① (each stream its own
    state) and decode on two streams at once, back to back: every launch
    ends and each stream's state is the plain version's after every
    chunk."""
    history = _history(5000, 2, cuda)
    chunks = [torch.from_numpy(_synth_chunk(size)).to(cuda) for size in (1 << 20, 4 << 20)]
    kw = dict(n_fields=40, hex_start=14, max_rows=1 << 14)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    states = [[tvocab.VocabState(history.clone(), torch.tensor(0, dtype=torch.int32,
                                                               device=cuda))] for _ in streams]
    snapshots = [[], []]
    for _ in range(3):
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                for c in chunks:
                    state = fdvops.fused_decode_update(states[i][-1], c, **kw)
                    states[i].append(state)
                    snapshots[i].append((state.first_pos.clone(), state.rows_seen.clone()))
                    dops.decode(c, _CRITEO_HEX, **_decode_kw(1 << 14))
    torch.cuda.synchronize()
    want = tvocab.VocabState(history.clone(), torch.tensor(0, dtype=torch.int32, device=cuda))
    wants = []
    for _ in range(3):
        for c in chunks:
            want = fdvref.fused_decode_genvocab(want, c, **kw)
            wants.append(want)
    for per_stream in snapshots:
        for (first_pos, rows_seen), w in zip(per_stream, wants):
            assert torch.equal(first_pos, w.first_pos)
            assert torch.equal(rows_seen, w.rows_seen)


def test_fused_decode_vocab_refuses_graph_capture(cuda):
    """A CUDA graph would replay one look-back epoch: capture raises."""
    history = _history(97, 4, cuda)
    buf = torch.from_numpy(_EDGE_CHUNKS["truncated_row"][0]).to(cuda)
    _assert_vocab_as_plain(buf, 256, history, calls=1)  # built and warmed up first
    state = tvocab.VocabState(history.clone(), torch.tensor(0, dtype=torch.int32, device=cuda))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            fdvops.fused_decode_update(state, buf, n_fields=40, hex_start=14, max_rows=256)


def test_fused_decode_vocab_is_one_kernel_a_call(cuda):
    """The profiler sees one device kernel per call of bytes-in loop ① on
    the synth 1 MiB chunk, and nothing else."""
    state = tvocab.VocabState(_history(5000, 5, cuda), torch.tensor(0, dtype=torch.int32,
                                                                     device=cuda))
    buf = torch.from_numpy(_synth_chunk(1 << 20)).to(cuda)
    found = device_kernels(torch, lambda: fdvops.fused_decode_update(
        state, buf, n_fields=40, hex_start=14, max_rows=1 << 14))
    assert list(found.values()) == [5], found


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


def _plain_genvocab(state, modded, valid):
    """The plain GenVocab of one chunk that may hold values outside
    [0, V): vref.genvocab and vref.genvocab_counts on the chunk with such
    cells dropped (given the min identity and no count), as the kernel and
    the reference's scatter drop them."""
    rows, n_cols = modded.shape
    vocab_range = state.first_pos.shape[1]
    pos = tvocab.positions(state.rows_seen, rows, valid)
    keep = (modded >= 0) & (modded < vocab_range)
    idx = torch.where(keep, modded, 0).t().to(torch.int64)
    src = torch.where(keep, pos[:, None], tvocab.NEVER).t()
    if bool(keep.all()):
        first = vref.genvocab(state.first_pos, modded.t(), pos)
    else:
        first = state.first_pos.scatter_reduce(1, idx, src, reduce="amin")
    counts = None
    if state.counts is not None:
        counts = (vref.genvocab_counts(state.counts, modded.t(), pos) if bool(keep.all())
                  else state.counts.scatter_add(1, idx, (src < tvocab.NEVER).to(torch.int32)))
    seen = tvocab.advance_rows_seen(state.rows_seen, valid.to(torch.int32).sum())
    return tvocab.VocabState(first, seen, counts)


_GENVOCAB_CASES = {  # name → (rows, n_cols, what)
    "rows_1": (1, 27, "random"), "rows_31": (31, 27, "random"), "rows_33": (33, 27, "random"),
    "rows_300": (300, 27, "random"), "all_invalid": (300, 27, "all_invalid"),
    "cols_40": (300, 40, "random"), "values_at_or_past_V": (300, 27, "out_of_range"),
    "one_warp_equal": (64, 27, "equal"),
}


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
@pytest.mark.parametrize("rows_seen", [0, tvocab.NEVER - 3], ids=["start", "ceiling"])
@pytest.mark.parametrize("case", list(_GENVOCAB_CASES))
def test_per_op_genvocab_one_launch_edge_cases(cuda, vocab_range, track_counts, rows_seen, case):
    """The one-launch genvocab against its plain version, bit for bit on
    first_pos, counts and rows_seen: a random valid mask (no prefix) at 1,
    31, 33 and 300 rows, no valid row, 40 columns (more than a block's 32
    warps), values at or past V (dropped), and 32 equal values in one warp
    (the count rises by each live row of the 32). One launch a call."""
    rows, n_cols, what = _GENVOCAB_CASES[case]
    rng = np.random.default_rng(vocab_range + rows + n_cols)
    modded = _modded(rng, rows, n_cols, vocab_range, cuda)
    valid = torch.from_numpy(rng.random(rows) < 0.7).to(cuda)
    if what == "all_invalid":
        valid.zero_()
    elif what == "out_of_range":
        modded[rng.random((rows, n_cols)) < 0.2] = vocab_range + 3
        modded[0, :3] = torch.tensor([vocab_range, 2**31 - 1, -1], dtype=torch.int32)
    elif what == "equal":
        modded[:32, 5] = vocab_range // 2
        valid[:32] = True
    history = torch.from_numpy(np.where(
        rng.random((n_cols, vocab_range)) < 0.2, rng.integers(0, 50, (n_cols, vocab_range)),
        tvocab.NEVER).astype(np.int32)).to(cuda)

    def fresh():
        counts = torch.ones_like(history) if track_counts else None
        return tvocab.VocabState(
            history.clone(), torch.tensor(rows_seen, dtype=torch.int32, device=cuda), counts)

    before = vops.KERNEL_GENVOCAB.launches
    got = vops.genvocab_update(fresh(), modded, valid)
    assert vops.KERNEL_GENVOCAB.launches == before + 1
    want = _plain_genvocab(fresh(), modded, valid)
    assert torch.equal(got.first_pos, want.first_pos)
    assert torch.equal(got.rows_seen, want.rows_seen)
    if track_counts:
        assert torch.equal(got.counts, want.counts)
        if what == "equal":  # counts started at 1
            pos = tvocab.positions(torch.tensor(rows_seen, device=cuda), rows, valid)
            hits = int(((modded[:, 5] == vocab_range // 2) & (pos < tvocab.NEVER)).sum())
            assert int(got.counts[5, vocab_range // 2]) == 1 + hits
            assert hits >= (32 if rows_seen == 0 else 3)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(_scratch.tally(cuda, stream)) == 0  # left at 0 for the next launch


def test_per_op_genvocab_streams_keep_their_own_tally(cuda):
    """Chunks on two streams at once: each stream's launches count into its
    own tally (the one fused_genvocab uses on that stream), and both
    states end as the plain version's."""
    rng = np.random.default_rng(21)
    modded = _modded(rng, 16384, 27, 5000, cuda)
    valid = torch.from_numpy(rng.random(16384) < 0.9).to(cuda)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for i, st in enumerate(streams):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            s = tvocab.VocabState.init(27, 5000, track_counts=True, device=cuda)
            s.rows_seen.fill_(i * 100)
            for _ in range(3):
                s = vops.genvocab_update(s, modded, valid)
            outs.append(s)
    torch.cuda.synchronize()
    assert _scratch.tally(cuda, streams[0].cuda_stream) is not _scratch.tally(
        cuda, streams[1].cuda_stream)
    for i, out in enumerate(outs):
        want = tvocab.VocabState.init(27, 5000, track_counts=True, device=cuda)
        want.rows_seen.fill_(i * 100)
        for _ in range(3):
            want = _plain_genvocab(want, modded, valid)
        assert torch.equal(out.first_pos, want.first_pos)
        assert torch.equal(out.counts, want.counts)
        assert torch.equal(out.rows_seen, want.rows_seen)


@pytest.mark.parametrize("track_counts", [False, True], ids=["plain", "counts"])
def test_per_op_genvocab_is_one_kernel_a_call(cuda, track_counts):
    """The profiler sees one device kernel per genvocab_update call on a
    [16384, 27] chunk, and no other device work."""
    rng = np.random.default_rng(22)
    modded = _modded(rng, 16384, 27, 5000, cuda)
    valid = torch.from_numpy(np.arange(16384) < 3745).to(cuda)
    state = tvocab.VocabState.init(27, 5000, track_counts=track_counts, device=cuda)
    found = device_kernels(torch, lambda: vops.genvocab_update(state, modded, valid))
    assert list(found.values()) == [5], found


@pytest.mark.parametrize("vocab_range", [97, 5000, 1_000_000])
def test_per_op_apply_vocab_kernel_matches_plain(cuda, vocab_range):
    rng = np.random.default_rng(vocab_range + 2)
    modded = _modded(rng, 300, 27, vocab_range, cuda)
    table = torch.from_numpy(
        rng.integers(0, 1000, size=(27, vocab_range)).astype(np.int32)).to(cuda)
    ids = vops.apply_vocab(table, modded)
    assert torch.equal(ids, vref.apply_vocab(table, modded.t()).t())
    assert torch.equal(ids, tvocab.lookup(tvocab.Vocabulary(table, None), modded))


# name → (rows, n_cols, vocab_range, offset): offset is the element of a
# larger buffer that the modded values start at (1: no 16-byte alignment)
_APPLY_CASES = {
    "crossed_16384x27": (16384, 27, 5000, 0),
    "rows_x_cols_not_a_multiple_of_4": (4099, 27, 1_000_000, 0),
    "one_column": (1027, 1, 97, 0),
    "64_columns": (517, 64, 5000, 0),
    "vocab_1": (301, 27, 1, 0),
    "vocab_2_31_minus_1": (257, 1, 2**31 - 1, 0),
    "misaligned_base": (4099, 27, 5000, 1),
    "misaligned_base_one_column": (63, 1, 97, 3),
}


@pytest.mark.parametrize("case", list(_APPLY_CASES))
def test_per_op_apply_vocab_edge_cases(cuda, case):
    """apply_vocab bit for bit against its plain version: element counts
    that are no multiple of 4, 1, 27 and 64 columns, V of 1 and 2^31 - 1
    (its one column's table is 8 GiB), modded values that start at an odd
    element of a larger buffer; and 0 for values outside [0, V)."""
    rows, n_cols, vocab_range, offset = _APPLY_CASES[case]
    rng = np.random.default_rng(rows + n_cols)
    gen = torch.Generator(cuda).manual_seed(rows)
    table = torch.randint(0, 2**31 - 1, (n_cols, vocab_range), generator=gen,
                          dtype=torch.int32, device=cuda)
    values = rng.integers(0, vocab_range, size=rows * n_cols + offset).astype(np.int32)
    values[offset:offset + 3] = [0, vocab_range - 1, vocab_range // 2]
    modded = torch.from_numpy(values).to(cuda)[offset:].view(rows, n_cols)
    assert modded.is_contiguous() and (modded.data_ptr() % 16 != 0) == (offset % 4 != 0)
    for _ in range(2):
        before = vops.KERNEL_APPLY.launches
        ids = vops.apply_vocab(table, modded)
        assert vops.KERNEL_APPLY.launches == before + 1
        assert torch.equal(ids, vref.apply_vocab(table, modded.t()).t())
    if vocab_range < 2**31 - 1:
        bad = modded.clone()
        bad.view(-1)[::7] = -1
        bad.view(-1)[3::7] = vocab_range
        ids = vops.apply_vocab(table, bad)
        ok = (bad >= 0) & (bad < vocab_range)
        want = vref.apply_vocab(table, torch.where(ok, bad, 0).t()).t()
        assert torch.equal(ids, torch.where(ok, want, 0))
    del table


def test_per_op_apply_vocab_is_one_kernel_a_call(cuda):
    """The profiler sees one device kernel per apply_vocab call on the
    crossed plan's [16384, 27] chunk, and no other device work."""
    rng = np.random.default_rng(23)
    modded = _modded(rng, 16384, 27, 5000, cuda)
    table = torch.from_numpy(rng.integers(0, 1000, size=(27, 5000)).astype(np.int32)).to(cuda)
    found = device_kernels(torch, lambda: vops.apply_vocab(table, modded))
    assert list(found.values()) == [5], found


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


def _dense_input(cuda, n, dtype, seed):
    """n int32 values (extremes first) or n f32 values (NaN, ±inf, -0.0 and
    1e-30 first), made on the card from a seed."""
    gen = torch.Generator(cuda).manual_seed(seed)
    if dtype == "int32":
        x = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=cuda,
                          generator=gen)
        head = torch.tensor([-(2**31), -1, 0, 1, 2**24 + 1, 2**31 - 1], dtype=torch.int32)
    else:
        x = torch.randn(n, device=cuda, generator=gen) * 1e3
        head = torch.tensor([float("nan"), -float("inf"), -0.0, 1e-30, 3.4e38, float("inf")])
    k = min(n, len(head))
    x[:k] = head[:k].to(cuda)
    return x


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (3, 1), (5, 13), (1001, 2), (16384, 12),
                                   (4099, 13), (1 << 22, 13)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_transform_quads_match_plain(cuda, shape, dtype):
    """dense_transform at rtol 1e-6 against its plain version, NaN equal:
    element counts 0, 1, 2 and 3 mod 4 (a ragged tail after the quads),
    the crossed plan's [16384, 12] group, and [2^22, 13], more than one
    resident wave of blocks."""
    x = _dense_input(cuda, shape[0] * shape[1], dtype, shape[0]).view(shape)
    dxops.KERNEL.launches = 0
    got = dxops.dense_transform(x)
    assert dxops.KERNEL.launches == 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got, dxref.dense_transform(x), rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 4099 * 13])
@pytest.mark.parametrize("x_off,out_off", [(1, 0), (0, 1), (1, 1), (2, 3), (3, 2)])
def test_dense_transform_misaligned_buffers(cuda, dtype, n, x_off, out_off):
    """Input and output that start 4, 8 or 12 bytes past a 16-byte boundary
    (contiguous slices buf[k:]): through the C entry, which writes nothing
    outside its output, and through the wrapper (which allocates its own
    output), at rtol 1e-6 against the plain version."""
    buf = _dense_input(cuda, n + 4, dtype, n)
    x = buf[x_off:x_off + n]
    out = torch.full((n + 4,), -7.0, device=cuda)
    p = dxops._build.ptr
    dxops.KERNEL.launch(cuda, p(x), p(out[out_off:]), n, int(dtype == "float32"))
    want = dxref.dense_transform(x)
    torch.testing.assert_close(out[out_off:out_off + n], want, rtol=1e-6, atol=0, equal_nan=True)
    assert bool((out[:out_off] == -7.0).all()) and bool((out[out_off + n:] == -7.0).all())
    torch.testing.assert_close(dxops.dense_transform(x), want, rtol=1e-6, atol=0, equal_nan=True)


def test_dense_transform_is_one_kernel_a_call(cuda):
    x = _dense_input(cuda, 16384 * 12, "int32", 7).view(16384, 12)
    found = device_kernels(torch, lambda: dxops.dense_transform(x))
    assert list(found.values()) == [5], found


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


@pytest.mark.parametrize("dtype,loss_rel,grad_rel_l2", [(torch.float32, 1e-5, 1e-4),
                                                        (torch.bfloat16, 1e-3, 5e-2)],
                         ids=["f32", "bf16"])
def test_lm_smoke_loss_and_gradients_on_card_match_cpu(cuda, dtype, loss_rel, grad_rel_l2):
    """gemma-2b SMOKE's LM.loss (chunked attention, remat, chunked CE over
    blocks of 32 with a padded tail) and every parameter's gradient on the
    card against the CPU path from the same weights (TF32 off): float32
    compute differs in summation order only; bf16 compute rounds at other
    points (the CPU tests hold the JAX package to the same bounds)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tgemma.SMOKE
    cpu_model = tlm.LM(cfg, ce_block=32, device="cpu")
    params = tsteps.trainable(cpu_model.init(torch.Generator().manual_seed(0)))
    card_params = tsteps.trainable(ttree.tree_map(lambda t: t.detach().to(cuda), params))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 72),
                                                                dtype=np.int32))
    want = cpu_model.loss(params, tokens, compute_dtype=dtype)
    want.backward()
    got = tlm.LM(cfg, ce_block=32, device=cuda).loss(card_params, tokens.to(cuda),
                                                     compute_dtype=dtype)
    got.backward()
    assert abs(float(got) / float(want) - 1) <= loss_rel
    for g, w in zip(leaves(card_params), leaves(params)):
        d = (g.grad.cpu() - w.grad).norm() / w.grad.norm()
        assert float(d) <= grad_rel_l2


# --------------------------------------------------------------------- #
# the MoE, SSM and hybrid layers on the card, against the CPU path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape_q,shape_kv", [((4, 16, 4096, 128), (4, 16, 4096, 128)),
                                              ((4, 25, 4096, 64), (4, 5, 4096, 64))],
                         ids=["qwen2_moe_d128", "hymba_gqa5_d64"])
def test_flash_kernel_at_the_zoo_prefill_shapes(cuda, shape_q, shape_kv):
    """The bf16 wgmma route at qwen2-moe's (16/16 heads, D 128) and hymba's
    (25 query heads over 5 kv heads, D 64) prefill shapes against ref.mha,
    causal, at the reference's 2e-2, one launch."""
    q, k, v = _qkv(shape_q, shape_kv, torch.bfloat16, 21, cuda)
    assert fops.route(q.dtype, q.shape[-1]) == "wgmma"
    fops.KERNEL.launches = 0
    got = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fops.KERNEL.launches == 1
    for b in range(q.shape[0]):
        want = fref.mha(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
        torch.testing.assert_close(got[b:b + 1].float(), want.float(), atol=2e-2, rtol=2e-2)


def _zoo_params(cfg):
    cpu = tlm.LM(cfg, device="cpu")
    return cpu, cpu.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("capacity_factor", [None, 1.0], ids=["smoke", "drops"])
def test_moe_routing_on_card_matches_cpu(cuda, capacity_factor):
    """qwen2-moe SMOKE's MoE layer in float32 (TF32 off) on the card: the
    experts, positions and keep masks of 384 tokens equal the CPU's bit for
    bit, with and without capacity drops, and the output and auxiliary loss
    agree to 1e-5 of their scale."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.get_smoke("qwen2-moe-a2.7b")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = tmlp.moe_init(torch.Generator().manual_seed(1), cfg, "swiglu", device="cpu")
    card = ttree.tree_map(lambda t: t.to(cuda), params)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 96, cfg.d_model)).astype(np.float32))
    want = tmlp.moe_route(x.reshape(-1, cfg.d_model), params, cfg)
    got = tmlp.moe_route(x.reshape(-1, cfg.d_model).to(cuda), card, cfg)
    for key in ("experts", "positions", "keep"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert bool((~want["keep"]).any()) == (capacity_factor is not None)
    out, aux = tmlp.moe_forward(x, params, cfg, "swiglu")
    gout, gaux = tmlp.moe_forward(x.to(cuda), card, cfg, "swiglu")
    assert float((gout.cpu() - out).abs().max()) <= 1e-5 * float(out.abs().max())
    assert abs(float(gaux) - float(aux)) <= 1e-5 * float(aux)


def test_ring_decode_on_card_matches_cpu(cuda):
    """hymba SMOKE with its windows cut to 8, decoding 24 tokens into a
    cache of 24 (the rings wrap twice) in float32 on the card and on the
    CPU: the logits at every step within 1e-4 of their largest value, every
    ring's slot_pos equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.get_smoke("hymba-1.5b")
    cfg = dataclasses.replace(cfg, superblock=tuple(
        dataclasses.replace(s, window=8) if s.window else s for s in cfg.superblock))
    cpu, params = _zoo_params(cfg)
    card = tlm.LM(cfg, device=cuda)
    card_params = ttree.tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24),
                                                                dtype=np.int32))
    cs = cpu.init_decode_state(2, 24, dtype=torch.float32)
    gs = card.init_decode_state(2, 24, dtype=torch.float32)
    for pos in range(24):
        w, cs = cpu.decode_step(params, tokens[:, pos], cs, pos, compute_dtype=torch.float32)
        g, gs = card.decode_step(card_params, tokens[:, pos].to(cuda), gs, pos,
                                 compute_dtype=torch.float32)
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())
    rings = [(a["kv"]["slot_pos"], b["kv"]["slot_pos"]) for sa, sb in zip(cs, gs)
             for a, b in zip(sa, sb) if "slot_pos" in a["kv"]]
    assert rings and all(torch.equal(a, b.cpu()) for a, b in rings)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_engine_serves_a_later_request_as_if_alone_on_card(cuda, arch):
    """ServeEngine on the card (SMOKE, bf16, 2 slots): a third request, in
    the slot of the first, gets the tokens and ends with the recurrent
    states that it gets served alone (the slot's states start anew)."""
    from repro_torch.serve import engine as tengine

    cfg = tconfigs.get_smoke(arch)
    model = tlm.LM(cfg, device=cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 5).tolist() for _ in range(3)]

    def serve(ps):
        eng = tengine.ServeEngine(model, params, batch_slots=2, cache_len=16)
        reqs = [tengine.Request(prompt=p, max_new_tokens=4) for p in ps]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    got, both = serve(prompts)
    want, alone = serve(prompts[2:])
    assert got[2] == want[0]
    states = [(a, b) for sa, sb in zip(both.state, alone.state) for ca, cb in zip(sa, sb)
              for (a, _), (b, _) in zip(tlm._recurrent_states(ca), tlm._recurrent_states(cb))]
    assert states
    for a, b in states:
        torch.testing.assert_close(a[0], b[0])


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_ssm_forward_equals_decode_chain_on_card(cuda, kind):
    """Each SSM block on the card, float32: its chunkwise forward over 40
    steps (chunks of 16, a padded last one) equals its decode chain, at
    tests/test_ssm.py's bounds (2e-4 Mamba, 5e-4 mLSTM; sLSTM's forward is
    the decode's recurrence, 1e-5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.get_smoke("hymba-1.5b" if kind == "mamba" else "xlstm-350m")
    init = {"mamba": tssm.mamba_init, "mlstm": tssm.mlstm_init, "slstm": tssm.slstm_init}[kind]
    fwd = {"mamba": tssm.mamba_forward, "mlstm": tssm.mlstm_forward,
           "slstm": tssm.slstm_forward}[kind]
    dec = {"mamba": tssm.mamba_decode, "mlstm": tssm.mlstm_decode,
           "slstm": tssm.slstm_decode}[kind]
    state0 = {"mamba": tssm.mamba_init_state, "mlstm": tssm.mlstm_init_state,
              "slstm": tssm.slstm_init_state}[kind]
    params = init(torch.Generator(cuda).manual_seed(3), cfg, device=cuda)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator(cuda).manual_seed(4),
                    device=cuda) * 0.3
    y, _ = fwd(x, params, cfg)
    state, ys = state0(2, cfg, device=cuda), []
    for t in range(40):
        y_t, state = dec(x[:, t:t + 1], state, params, cfg)
        ys.append(y_t)
    tol = {"mamba": 2e-4, "mlstm": 5e-4, "slstm": 1e-5}[kind]
    torch.testing.assert_close(y, torch.cat(ys, 1), atol=tol, rtol=0)


# --------------------------------------------------------------------- #
# cross-attention on the card, against the plain version and the CPU path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape_q,shape_kv,causal,strided", [
    ((4, 64, 4096, 128), (4, 8, 4096, 128), True, False),
    ((4, 64, 4096, 128), (4, 8, 1024, 128), False, True),
    ((16, 12, 256, 64), (16, 12, 256, 64), True, False)],
    ids=["llama_vision_self", "llama_vision_cross_strided", "whisper_decoder_self"])
def test_flash_kernel_at_the_cross_prefill_shapes(cuda, shape_q, shape_kv, causal, strided):
    """The bf16 wgmma route at llama-3.2-vision's self-attention (64 query
    heads over 8 kv heads, D 128, causal) and cross-attention shapes (4096
    queries over 1024 keys, not causal: each query tile walks 8 kv tiles),
    the latter with k and v as attention.context_kv hands them over ([B, S,
    Hkv, D] viewed as [B, Hkv, S, D], read through the tensor maps'
    strides), and at whisper-small's decoder self-attention (16 × 256, 12
    heads, D 64), against ref.mha at the reference's 2e-2, one launch."""
    q, k, v = _qkv(shape_q, shape_kv, torch.bfloat16, 22, cuda)
    if strided:
        k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
        assert not k.is_contiguous() and k.stride(2) == shape_kv[1] * shape_kv[3]
    assert fops.route(q.dtype, q.shape[-1]) == "wgmma"
    fops.KERNEL.launches = 0
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.KERNEL.launches == 1
    for b in range(q.shape[0]):
        want = fref.mha(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal)
        torch.testing.assert_close(got[b:b + 1].float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_cross_smoke_on_card_matches_cpu(cuda, arch):
    """SMOKE of the vision LM and of the encoder-decoder, float32 (TF32
    off), the card on the flash route (every layer here: 64 tokens, 16
    patches or 32 frames) and the CPU on the chunked route from the same
    weights and stub inputs: the forward's logits within 1e-4 of their
    largest value, then 8 decode steps after fill_context_caches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.get_smoke(arch)
    cpu = tspecs.build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = tspecs.build_model(cfg, attn_impl="flash", device=cuda)
    card_params = ttree.tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32))
    length = cfg.encoder_frames if cfg.family == "audio" else cfg.vision_tokens
    stub = torch.from_numpy(rng.standard_normal((2, length, cfg.d_model)).astype(np.float32) * 0.1)
    f32 = torch.float32
    with torch.no_grad():
        if cfg.family == "audio":
            cpu_dec, card_dec = cpu.decoder, card.decoder
            cpu_ctx = cpu.encode(params, stub, f32)
            card_ctx = card.encode(card_params, stub.to(cuda), f32)
        else:
            cpu_dec, card_dec, cpu_ctx, card_ctx = cpu, card, stub, stub.to(cuda)
        want = cpu_dec.forward(params, tokens, f32, context=cpu_ctx)
        fops.KERNEL.launches = 0
        got = card_dec.forward(card_params, tokens.to(cuda), f32, context=card_ctx)
        torch.cuda.synchronize()
        assert fops.KERNEL.launches == cfg.n_layers
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
        cs = cpu_dec.fill_context_caches(params, cpu_dec.init_decode_state(2, 8, dtype=f32),
                                         cpu_ctx)
        gs = card_dec.fill_context_caches(card_params,
                                          card_dec.init_decode_state(2, 8, dtype=f32), card_ctx)
        for pos in range(8):
            w, cs = cpu_dec.decode_step(params, tokens[:, pos], cs, pos, compute_dtype=f32)
            g, gs = card_dec.decode_step(card_params, tokens[:, pos].to(cuda), gs, pos,
                                         compute_dtype=f32)
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


# --------------------------------------------------------------------- #
# sharded training: the expert-parallel MoE path, the sharded Trainer, the
# int8 compressed mean, the elastic restore (every mesh position on cuda:0)
# --------------------------------------------------------------------- #
class _F32LM(tlm.LM):
    """The LM with float32 compute in its loss."""

    def loss(self, params, tokens, compute_dtype=torch.float32, aux_weight=0.01, context=None):
        return super().loss(params, tokens, torch.float32, aux_weight, context)


def _moe_smoke(capacity_factor=1.25):
    cfg = tconfigs.get_smoke("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


def _mesh_shardings(model, mesh):
    skeleton = tlm.LM(model.cfg, device="meta").init()
    return (tsharding.param_shardings(skeleton, mesh),
            tsharding.param_shardings(topt.adamw_init(skeleton), mesh),
            tsharding.NamedSharding(mesh, tsharding.batch_spec(mesh)))


def test_ep_prefill_on_card_equals_the_dense_path_per_shard(cuda):
    """qwen2-moe SMOKE at capacity 1.25 (choices drop), float32, TF32 off,
    on the flash route (one launch a layer) over mesh (2, 4) on cuda:0: the
    EP trunk equals the dense path run on each data shard's rows within
    1e-5 relative L2, its auxiliary loss the shards' mean within 1e-6."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_smoke()
    model = tlm.LM(cfg, attn_impl="flash", device=cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=cuda.type)
    assert mesh.distinct_devices() == [torch.device(cuda.type, 0 if cuda.type == "cuda" else None)]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 128), dtype=np.int32)).to(cuda)
    real, drops = tmlp.moe_route, []

    def spy(xt, p, c):
        r = real(xt, p, c)
        drops.append(int((~r["keep"]).sum()))
        return r

    with torch.no_grad():
        tmlp.moe_route = spy
        try:
            fops.KERNEL.launches = 0
            with tsharding.use_mesh(mesh):
                x_ep, aux_ep = model.trunk(params, tokens, torch.float32)
            torch.cuda.synchronize()
            assert fops.KERNEL.launches == cfg.n_layers
        finally:
            tmlp.moe_route = real
        parts = [model.trunk(params, t, torch.float32) for t in tokens.chunk(2)]
    assert len(drops) == 2 * cfg.n_layers and sum(drops) > 0
    want = torch.cat([x for x, _ in parts])
    assert float((x_ep - want).norm() / want.norm()) <= 1e-5
    aux = torch.stack([a for _, a in parts]).mean()
    assert abs(float(aux_ep) / float(aux) - 1) <= 1e-6


def _card_trainer(root, cfg, tokens, cuda, mesh=None, total_steps=2, ckpt_every=100):
    model = _F32LM(cfg, device=cuda)
    tcfg = ttrainer.TrainerConfig(total_steps=total_steps, ckpt_dir=str(root),
                                  ckpt_every=ckpt_every, handle_signals=False)
    return ttrainer.Trainer(model, topt.AdamWConfig(), tcfg, lambda s: {"tokens": tokens[s]},
                            mesh=mesh, shardings=None if mesh is None else
                            _mesh_shardings(model, mesh))


def test_sharded_trainer_on_card_matches_the_unsharded_trainer(cuda, tmp_path):
    """qwen2-moe SMOKE, float32, TF32 off, 2 steps under use_mesh (EP with
    autograd) on mesh (2, 4), sharded and unsharded from the same seed:
    losses within 1e-5 relative, every weight within lr / 10, and the
    sharded run's blocks views of its whole tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_smoke()
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=cuda.type)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 4, 64), dtype=np.int32))
    runs = []
    for name, m in (("plain", None), ("sharded", mesh)):
        with tsharding.use_mesh(mesh):
            runs.append(_card_trainer(tmp_path / name, cfg, tokens, cuda, mesh=m).run(0))
    plain, sharded = runs
    np.testing.assert_allclose(sharded["losses"], plain["losses"], rtol=1e-5, atol=0)
    for a, b in zip(leaves(sharded["params"]), leaves(plain["params"])):
        assert float((a.detach() - b.detach()).abs().max()) <= 1e-3 / 10
    for st, t in zip(leaves(sharded["placement"]["params"]), leaves(sharded["params"])):
        assert all(b.device == t.device
                   and b.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
                   for b in st.blocks)


def test_compressed_mean_on_card_equals_the_cpu(cuda):
    """compressed_psum_mean over [2, ...] leaves on the card, three rounds
    of error feedback, equal to the CPU's bit for bit, and the card's
    residual y - dequant exact."""
    rng = np.random.default_rng(6)
    shapes = {"a": (2, 300, 7), "b": (2, 1000), "z": (2, 3)}
    err_c = tcomp.error_state_init({k: torch.zeros(s) for k, s in shapes.items()})
    err_g = ttree.tree_map(lambda t: t.to(cuda), err_c)
    for r in range(3):
        g = {k: torch.from_numpy((rng.standard_normal(s) * 10.0 ** r).astype(np.float32))
             for k, s in shapes.items()}
        g["z"].zero_()
        mean_c, err_c = tcomp.compressed_psum_mean(g, err_c)
        mean_g, err_g = tcomp.compressed_psum_mean(ttree.tree_map(lambda t: t.to(cuda), g),
                                                   err_g)
        for k in shapes:
            assert torch.equal(mean_g[k].cpu(), mean_c[k]) and torch.equal(err_g[k].cpu(),
                                                                          err_c[k])


def test_elastic_resume_on_card(cuda, tmp_path):
    """qwen2-moe SMOKE, float32: two steps under mesh (2, 4) with a
    checkpoint; restored with a sharding_fn onto (4, 2), every block on the
    card and the whole equal to the saved leaf bit for bit; a Trainer on
    (4, 2) and one with no mesh resume it, their first resumed losses equal
    bit for bit and their final weights within lr / 10."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_smoke()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 4, 64), dtype=np.int32))
    mesh, other = (tmesh.make_mesh(s, ("data", "model"), devices=cuda.type)
                   for s in ((2, 4), (4, 2)))
    _card_trainer(tmp_path / "written", cfg, tokens, cuda, mesh=mesh).run(0)
    like = tinterop.lm_train_state_like(cfg)
    back = tckpt.restore(str(tmp_path / "written"), 2, like,
                         sharding_fn=lambda t: tsharding.param_shardings(t, other))
    plain = tckpt.restore(str(tmp_path / "written"), 2, like, device="cpu")
    for st, want in zip(leaves(back), leaves(plain)):
        assert all(b.device.type == cuda.type for b in st.blocks)
        assert torch.equal(st.full().cpu(), want)
    runs = []
    for name, m in (("other", other), ("none", None)):
        shutil.copytree(tmp_path / "written" / "step_00000002",
                        tmp_path / name / "step_00000002")
        runs.append(_card_trainer(tmp_path / name, cfg, tokens, cuda, mesh=m,
                                  total_steps=4).run(0))
    assert runs[0]["losses"][0] == runs[1]["losses"][0]
    for a, b in zip(leaves(runs[0]["params"]), leaves(runs[1]["params"])):
        assert float((a.detach() - b.detach()).abs().max()) <= 1e-3 / 10


# --------------------------------------------------------------------- #
# host threads and the streaming service's streams
# --------------------------------------------------------------------- #

def _decode_in_thread(chunks, stream, out, errors):
    try:
        ctx = torch.cuda.stream(stream) if stream is not None else torch.cuda.device(0)
        with ctx:
            for _ in range(8):
                for c in chunks:
                    out.append((c, dops.decode(c, _CRITEO_HEX, **_decode_kw(256))))
    except Exception as e:  # noqa: BLE001 — asserted below
        errors.append(e)


@pytest.mark.parametrize("streams", [1, 2], ids=["one_stream", "two_streams"])
def test_decodes_from_two_threads_equal_plain(cuda, streams):
    """Two host threads decode at once, on one stream (they share its
    look-back scratch, so each epoch must be taken and launched under its
    lock) and then on a stream each: every result is the plain version's."""
    chunks = [torch.from_numpy(_EDGE_CHUNKS[n][0]).to(cuda)
              for n in ("truncated_row", "long_field_over_two_tiles", "ends_on_16384")]
    side = [torch.cuda.Stream(cuda) for _ in range(streams)]
    for s in side:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs, errors = [[], []], []
    threads = [threading.Thread(target=_decode_in_thread,
                                args=(chunks, side[i % streams], outs[i], errors))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    torch.cuda.synchronize()
    for per_thread in outs:
        assert len(per_thread) == 8 * len(chunks)
        for c, got in per_thread:
            for g, w in zip(got, dref.decode_bytes(c, _CRITEO_HEX, **_decode_kw(256))):
                assert torch.equal(g, w)


def _stream_world(cuda, fmt="utf8", buckets=(64,)):
    """A scheduler on the card over the 400-row synth data, its requests
    and the offline table of their rows."""
    from repro_torch.stream import make_request, scheduler

    buf, table = synth.make_dataset(synth.SynthConfig(rows=400, seed=42))
    cfg = P.PipelineConfig(input_format=fmt, device="cuda")
    chunks = list(synth.chunk_stream(buf, 1 << 16)) if fmt == "utf8" else [
        {k: table[k] for k in ("label", "dense", "sparse")}]
    pipe = P.PiperPipeline(cfg)
    vocab = tvocab.finalize(pipe.build_state_stream(chunks))
    outs = list(pipe.transform_stream(vocab, chunks))
    want = {f: torch.cat([getattr(o, f)[o.valid] for o in outs]).cpu().numpy()
            for f in ("label", "dense", "sparse")}
    sched = scheduler.MicroBatchScheduler(cfg, vocab, bucket_rows=buckets)
    payloads = list(synth.request_payloads(buf, table, [50] * 8, input_format=fmt))
    reqs = [make_request(p, cfg) for p in payloads]
    return sched, reqs, want


def _assert_rows(got, want, row0):
    for f in ("label", "sparse"):
        np.testing.assert_array_equal(got[f], want[f][row0:row0 + got[f].shape[0]])
    np.testing.assert_allclose(got["dense"], want["dense"][row0:row0 + got["dense"].shape[0]],
                               rtol=1e-6, atol=0)


SLEEP_CYCLES = 300_000_000  # ~0.15 s of device time at the H100's clock


def test_pinned_slot_is_not_refilled_before_its_copy(cuda):
    """With batch 1's copy in held back behind a long kernel, filling its
    staging slot again (batch 3) waits for the event behind that copy, so
    batch 1 still serves its own rows."""
    sched, reqs, want = _stream_world(cuda)
    bucket = sched.buckets[0]
    assert len(bucket.slots) == 2 and all(s.chunk.is_pinned() for s in bucket.slots)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)
        b1 = sched.assemble([reqs[0]])
        o1 = sched.dispatch(b1)
        b2 = sched.assemble([reqs[1]])
        o2 = sched.dispatch(b2)
        assert not b1.slot.copied.query()  # the copy in is still queued
        t0 = time.perf_counter()
        b3 = sched.assemble([reqs[2]])  # batch 1's slot again
        waited = time.perf_counter() - t0
        assert b3.slot is b1.slot and waited > 0.02
        o3 = sched.dispatch(b3)
        for i, (b, o) in enumerate(((b1, o1), (b2, o2), (b3, o3))):
            _assert_rows(sched.route(b, o)[0], want, 50 * i)


def test_route_does_not_wait_for_the_next_batch(cuda):
    """Batch 2 queued behind a long kernel: routing batch 1 returns before
    it, on batch 1's own event."""
    sched, reqs, want = _stream_world(cuda)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        b1 = sched.assemble([reqs[0]])
        o1 = sched.dispatch(b1)
        torch.cuda._sleep(SLEEP_CYCLES)
        b2 = sched.assemble([reqs[1]])
        o2 = sched.dispatch(b2)
        t0 = time.perf_counter()
        got = sched.route(b1, o1)[0]
        took = time.perf_counter() - t0
        assert not b2.returned.query(), "batch 2 finished: the test shows nothing"
        assert took < 0.05
        _assert_rows(got, want, 0)
        _assert_rows(sched.route(b2, o2)[0], want, 50)


@pytest.mark.parametrize("fmt", ["utf8", "binary"])
def test_service_results_stay_valid_after_later_batches(cuda, fmt):
    """Each request owns its result: the batches served after it through
    the same pinned slots leave it unchanged."""
    from repro_torch.stream import StreamingPreprocessService

    buf, table = synth.make_dataset(synth.SynthConfig(rows=400, seed=42))
    cfg = P.PipelineConfig(input_format=fmt, device="cuda")
    chunks = list(synth.chunk_stream(buf, 1 << 16)) if fmt == "utf8" else [
        {k: table[k] for k in ("label", "dense", "sparse")}]
    state = P.PiperPipeline(cfg).build_state_stream(chunks)
    payloads = list(synth.request_payloads(buf, table, [40] * 10, input_format=fmt))
    with StreamingPreprocessService(cfg, state, bucket_rows=(64,)) as svc:
        first = svc.submit(payloads[0]).result(timeout=120)
        kept = {k: v.copy() for k, v in first.items()}
        for p in payloads[1:] * 4:
            svc.submit(p)
        svc.drain(timeout=120)
    for k, v in kept.items():
        np.testing.assert_array_equal(first[k], v)


def test_absorb_on_another_stream_is_merged_after_its_kernels(cuda):
    """absorb's kernels held back behind a long kernel on the caller's
    stream: the loop stream's merge waits for them (the event of
    refresh_vocab), so the merged state is offline loop ① over the rows."""
    from repro_torch.stream import StreamingPreprocessService

    buf, table = synth.make_dataset(synth.SynthConfig(rows=400, seed=42))
    spans = synth.row_spans(buf)
    cfg = P.PipelineConfig(device="cuda", max_rows_per_chunk=256, chunk_bytes=1 << 16)
    pipe = P.PiperPipeline(cfg)
    first = buf[: spans[199, 1]]
    second = buf[spans[200, 0]: spans[399, 1]]
    state = pipe.build_state_stream(synth.chunk_stream(first, 1 << 16))
    offline = pipe.build_state_stream(synth.chunk_stream(buf, 1 << 16))
    errors = []
    with StreamingPreprocessService(cfg, tvocab.VocabState(state.first_pos.clone(),
                                                            state.rows_seen.clone()),
                                    bucket_rows=(64,)) as svc:
        def absorb():
            try:
                with torch.cuda.stream(torch.cuda.Stream(cuda)):
                    torch.cuda._sleep(SLEEP_CYCLES)
                    svc.absorb(second, row_offset=200)
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        t = threading.Thread(target=absorb)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and not errors
        applied = svc.registry.counter("stream.vocab_apply_total")
        deadline = time.monotonic() + 120
        while applied.value < 1:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        merged = svc.vocab_state
        assert torch.equal(merged.first_pos, offline.first_pos)
        assert int(merged.rows_seen) == int(offline.rows_seen) == 400
        assert svc.last_swap_seconds() > 0


def test_spans_are_nvtx_ranges_on_the_card(cuda):
    from repro_torch.obs import trace

    tracer = trace.Tracer()
    assert tracer.device == "cuda" and tracer.nvtx
    with tracer.span("stream/dispatch"):
        torch.ones(4, device=cuda).sum()
    assert [e["name"] for e in tracer.events()] == ["stream/dispatch"]


def _token_batch(step: int) -> dict:
    rng = np.random.default_rng(step)
    return {"tokens": rng.integers(0, 1 << 30, (512, 64), dtype=np.int32),
            "dense": rng.standard_normal((512, 13)).astype(np.float32)}


def test_device_prefetcher_reuses_pinned_buffers_under_a_slow_consumer(cuda):
    """The prefetcher's copies held back behind a long kernel on its own
    stream: the producer fills its depth + 2 pinned slots, then waits for a
    slot's copy before writing it again, so every batch still holds its
    own step's values; the consumer (slow, and computing on its own stream
    right after get()) reads each batch only after its copy."""
    from repro_torch.data import loader

    pf = loader.DevicePrefetcher(_token_batch, depth=2, device="cuda")
    with torch.cuda.stream(pf._stream):
        torch.cuda._sleep(SLEEP_CYCLES)
    pf.start()
    try:
        kept = []
        for want in range(12):
            step, batch = pf.get(timeout=120)
            assert step == want
            assert all(t.device.type == "cuda" for t in batch.values())
            kept.append((step, {k: v.clone() for k, v in batch.items()}))  # on this stream
            time.sleep(0.01)
    finally:
        pf.stop()
    torch.cuda.synchronize()
    assert pf.stager.pinned_buffers() == 4 * 2  # depth + 2 slots, two fields each
    for step, batch in kept:
        for k, v in _token_batch(step).items():
            assert torch.equal(batch[k].cpu(), torch.from_numpy(v)), (step, k)


def test_input_pipeline_batches_equal_across_overlap_on_the_card(cuda):
    """The service on the card feeding TrainInputPipeline: overlap on and
    off give the same batches, bit for bit, all on the card, and they equal
    the CPU service's (dense at rtol 1e-6)."""
    from repro_torch.stream import StreamingPreprocessService
    from repro_torch.train import input_pipeline

    buf, table = synth.make_dataset(synth.SynthConfig(rows=1024, seed=5))
    payloads = list(synth.request_payloads(buf, table, [128] * 8))

    def batches(device, overlap):
        cfg = P.PipelineConfig(device=device, max_rows_per_chunk=1024, chunk_bytes=1 << 18)
        state = P.PiperPipeline(cfg).build_state_stream(synth.chunk_stream(buf, 1 << 18))
        with StreamingPreprocessService(cfg, state, bucket_rows=(128,)) as svc:
            return [dict(b) for b in input_pipeline.TrainInputPipeline(
                svc, payloads, batch_rows=200, n_steps=7, overlap=overlap, device=device)]

    off, on, cpu = batches("cuda", False), batches("cuda", True), batches("cpu", True)
    for a, b, c in zip(off, on, cpu):
        for k in input_pipeline.FIELDS:
            assert a[k].device.type == b[k].device.type == "cuda"
            assert torch.equal(a[k], b[k]), k
        for k in ("label", "sparse"):
            assert torch.equal(a[k].cpu(), c[k]), k
        torch.testing.assert_close(a["dense"].cpu(), c["dense"], rtol=1e-6, atol=0)


# --------------------------------------------------------------------- #
# the sharded engines: every shard on cuda:0, against the CPU path
# --------------------------------------------------------------------- #

SHARDED_ROUTES = {"utf8": ("utf8", {}), "utf8_bytes_in": ("utf8", {"use_fused_decode": True}),
                  "binary": ("binary", {}), "utf8_counts": ("utf8", {"track_vocab_counts": True})}


def _sharded_feed(feed, n_shards):
    from repro_torch.data import loader

    buf, table = synth.make_dataset(synth.SynthConfig(rows=600, seed=11))
    if feed == "utf8":
        return loader.TabularChunkFeed(buf, 8192, n_shards).shard_stacks()
    return loader.BinaryChunkFeed(table, 128, n_shards).shard_stacks()


def _assert_outputs_match(card, cpu):
    for f in ("label", "sparse", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    torch.testing.assert_close(card.dense.cpu(), cpu.dense, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("route", list(SHARDED_ROUTES))
def test_row_parallel_on_card_equals_cpu(cuda, route, n_shards):
    """ShardedPiperPipeline with every shard on cuda:0 (the kernels of each
    route) gives the CPU path's merged state and outputs, pad chunks
    included: integers bit for bit, dense at rtol 1e-6."""
    from repro_torch.core import sharded_pipeline as SP
    from repro_torch.launch import mesh as tmesh

    feed, fields = SHARDED_ROUTES[route]
    stacks, offsets = _sharded_feed(feed, n_shards)
    got = {}
    for device in ("cuda", "cpu"):
        cfg = P.PipelineConfig(chunk_bytes=8192, max_rows_per_chunk=128, input_format=feed,
                               device=device, **fields)
        eng = SP.ShardedPiperPipeline(cfg, tmesh.make_data_mesh(n_shards, device=device))
        assert {d.type for d in eng.devices} == {device}
        got[device] = (eng.build_state_scan(stacks, offsets), eng.run_scan(stacks, offsets))
    (card_state, card_out), (cpu_state, cpu_out) = got["cuda"], got["cpu"]
    for f in ("first_pos", "rows_seen", "counts"):
        a, b = getattr(card_state, f), getattr(cpu_state, f)
        assert (a is None and b is None) or torch.equal(a.cpu(), b), f
    _assert_outputs_match(card_out, cpu_out)


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))],
                         ids=["2x4", "2x2x2"])
def test_column_parallel_on_card_equals_cpu(cuda, shape, axes):
    """ShardedPiper with every position on cuda:0 (decode, genvocab,
    apply_vocab and dense_transform a position and step) gives the CPU
    path's stacked state, vocabulary and outputs."""
    from repro_torch.core import sharded as Sh
    from repro_torch.data import loader
    from repro_torch.launch import mesh as tmesh

    buf, _ = synth.make_dataset(synth.SynthConfig(rows=600, seed=11))
    got = {}
    for device in ("cuda", "cpu"):
        cfg = P.PipelineConfig(chunk_bytes=8192, max_rows_per_chunk=128, device=device)
        eng = Sh.ShardedPiper(cfg, tmesh.make_mesh(shape, axes, devices=device))
        feed = loader.TabularChunkFeed(buf, 8192, eng.n_row_shards)
        state = eng.init_state()
        for i in range(feed.n_steps):
            state = eng.vocab_step(state, feed.stacked[i], feed.offsets[i])
        voc = eng.stacked_vocabulary(eng.finalize(state))
        got[device] = (eng.stacked_state(state), voc, eng.run_scan(feed.stacked, feed.offsets))
    (cs, cv, co), (ps, pv, po) = got["cuda"], got["cpu"]
    assert torch.equal(cs.cpu(), ps)
    assert torch.equal(cv.table.cpu(), pv.table) and torch.equal(cv.sizes.cpu(), pv.sizes)
    _assert_outputs_match(co, po)


def test_all_reduce_state_over_gloo_on_the_card(cuda, tmp_path):
    """Two processes, each with its local state on cuda:0, merged by
    all_reduce_state over gloo (NCCL refuses two ranks on one device):
    every rank ends with the single-process merge on the card."""
    from repro_torch.core import sharded_pipeline as SP
    from repro_torch.launch import mesh as tmesh
    from torch_ranks import run_ranks  # tests/ is on sys.path (pytest prepends it)

    stacks, offsets = _sharded_feed("utf8", 2)
    cfg = P.PipelineConfig(chunk_bytes=8192, max_rows_per_chunk=128, device="cuda",
                           track_vocab_counts=True)
    want = SP.ShardedPiperPipeline(cfg, tmesh.make_data_mesh(2)).build_state_scan(stacks, offsets)
    for got in run_ranks(2, stacks, offsets, tmp_path, chunk_bytes=8192, max_rows=128,
                         device="cuda"):
        assert np.array_equal(got["first_pos"], want.first_pos.cpu().numpy())
        assert np.array_equal(got["rows_seen"], want.rows_seen.cpu().numpy())
        assert np.array_equal(got["counts"], want.counts.cpu().numpy())


# --------------------------------------------------------------------- #
# the static gate on the card (repro_torch.analysis)
# --------------------------------------------------------------------- #
def test_launch_configs_equal_the_declarations(cuda):
    """Every library's launch_accounting equals its <library>_launch_config
    at the main path's shapes and their edges."""
    from repro_torch.analysis import kernelcheck
    from repro_torch.kernels import _build

    found, records = kernelcheck.check_launch_configs(cuda)
    assert found == []
    assert {r["library"] for r in records} == set(_build.SOURCES)
    assert all(r["equal"] for r in records)


@pytest.mark.parametrize("routing", ["fused", "counts", "kernels"])
def test_audited_routes_launch_exactly_their_entries(cuda, routing):
    """Each hot-path call's kernel entries (launch_audit) equal its launch
    counters and the hand-written kernels the profiler sees, exactly, and
    no call synchronises the host (sync debug mode "error")."""
    import re

    from repro_torch.analysis import kernelcheck, launch_audit
    from repro_torch.core import plan_compiler as tcomp
    from repro_torch.core import schema as tschema
    from repro_torch.kernels import _build

    hints = {"fused": {"fused": True, "fused_vocab": True, "fused_decode": True},
             "counts": {"fused": True, "fused_vocab": True, "track_counts": True},
             "kernels": {"use_kernels": True}}[routing]
    compiled = tcomp.compile_plan(tplan.criteo_default(tschema.CRITEO), tschema.CRITEO,
                                  device=cuda, **hints)
    inputs = launch_audit.route_inputs(compiled, 512)
    calls = launch_audit.hot_path_calls(compiled, inputs)
    calls.update({f"route/{k}": v for k, v in launch_audit.route_calls(compiled, inputs).items()})
    found, traced = launch_audit.audit_calls(calls, cuda, context=routing)
    assert found == []
    from repro_torch.analysis.__main__ import repo_root

    _, threads = kernelcheck.audit_sources(kernelcheck.read_sources(repo_root()))
    hand = re.compile(r"(?:::|\s)(?:" + "|".join(sorted(threads)) + r")[<(]")
    for name, call in calls.items():
        entries = traced[name].entries
        kernels = {k for e in entries for k in _build.ENTRIES[e]}
        before = {k: k.launches for k in kernels}
        call()
        torch.cuda.synchronize()
        for entry, n in entries.items():
            assert sum(k.launches - before[k] for k in _build.ENTRIES[entry]) == n, (name, entry)
        seen = device_kernels(torch, call, calls=4)
        assert sum(n for k, n in seen.items() if hand.search(" " + k)) == 4 * sum(
            entries.values()), (name, seen)


def test_jx301_decides_under_sync_debug_mode(cuda):
    from repro_torch.analysis import launch_audit

    x = torch.ones(4, device=cuda)
    found, _ = launch_audit.audit_calls({"read": lambda: x.sum().item(), "stay": lambda: x + 1},
                                        cuda, context="seeded")
    assert [(f.rule, f.obj) for f in found] == [("JX301", "seeded/read")]
    assert tvocab.check_row_ceiling(torch.zeros((), dtype=torch.int32, device=cuda), 10) is None


def test_analysis_gate_strict_on_the_card(cuda, tmp_path):
    from repro_torch.analysis import __main__ as gate

    assert gate.main(["--strict", "--device", "cuda", "--json", str(tmp_path / "r.json")]) == 0
