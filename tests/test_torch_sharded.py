"""The port's sharded engines on the CPU: the row-parallel
``ShardedPiperPipeline`` (repro_torch.core.sharded_pipeline) and the
column-parallel ``ShardedPiper`` (repro_torch.core.sharded), on meshes of
``device="cpu"`` positions, at 600 rows in 8 KiB chunks of at most 128
rows.

- The row-parallel engine at 1, 2, 3, 4 and 8 shards, on utf8 (decoded and
  bytes-in) and binary feeds, against the JAX package's single-device
  ``PiperPipeline.run_scan`` and ``build_vocab_scan`` on the same chunk
  sequence, pad chunks included; with the count plane, against JAX
  ``build_state_stream``'s state.
- Both engines against the JAX package's own sharded engines, run once in
  a subprocess with 4 forced host devices: the merged and the stacked
  per-shard states, the vocabularies and the outputs, padding columns
  included.
- Their refusals, and ``all_reduce_state`` over gloo in 2 and 4 processes
  against the single-process merge.

Integers, states and vocabularies are compared bit for bit. Dense values
are bit for bit against the port's single-device engine; against the JAX
package they are held at rtol 1e-6, since ``torch.log1p`` and XLA's
``log1p`` round about one value in a hundred one ulp apart on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JP
from repro.data import synth as jsynth
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import plan as tplan
from repro_torch.core import sharded as TSh
from repro_torch.core import sharded_pipeline as TSP
from repro_torch.core import vocab as tvocab
from repro_torch.data import loader as tloader
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from tests.multidevice import run_with_devices
from tests.torch_ranks import run_ranks

ROWS, SEED, CHUNK_BYTES, MAX_ROWS = 600, 11, 8192, 128
SHARDS = [1, 2, 3, 4, 8]
# route → (feed, port config fields)
ROUTES = {"utf8": ("utf8", {}), "utf8_bytes_in": ("utf8", {"use_fused_decode": True}),
          "binary": ("binary", {})}
FIELDS = ("label", "sparse", "valid")


@pytest.fixture(scope="module")
def data():
    return jsynth.make_dataset(jsynth.SynthConfig(rows=ROWS, seed=SEED))


def _port_config(feed, **kw):
    return TP.PipelineConfig(chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS,
                             input_format=feed, device="cpu", **kw)


def _feed(data, feed, n_shards):
    """(shard stacks, offsets, the single-device chunk sequence)."""
    buf, table = data
    if feed == "utf8":
        f = tloader.TabularChunkFeed(buf, CHUNK_BYTES, n_shards)
        stacks, offsets = f.shard_stacks()
        return stacks, offsets, f.stacked.reshape(-1, CHUNK_BYTES)
    f = tloader.BinaryChunkFeed(table, MAX_ROWS, n_shards)
    stacks, offsets = f.shard_stacks()
    return stacks, offsets, f.flat_chunks()


_JAX = {}  # (feed, chunks) → the JAX single-device engine's outputs


def _jax_single(feed, flat):
    """The JAX package's single-device run_scan and build_vocab_scan over
    ``flat``, once per feed and chunk count (the pad chunks differ only in
    number)."""
    n = len(flat["label"]) if feed == "binary" else len(flat)
    if (feed, n) not in _JAX:
        pipe = JP.PiperPipeline(JP.PipelineConfig(
            chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, input_format=feed,
            use_fused_kernel=False))
        stacked = ({k: jnp.asarray(v) for k, v in flat.items()} if feed == "binary"
                   else jnp.asarray(flat))
        out = JP.flatten_processed(pipe.run_scan(stacked))
        voc = pipe.build_vocab_scan(stacked)
        _JAX[(feed, n)] = ({f: np.asarray(getattr(out, f)) for f in FIELDS + ("dense",)},
                           np.asarray(voc.table), np.asarray(voc.sizes))
    return _JAX[(feed, n)]


def _assert_batch(got, want_ints, what, dense=None):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want_ints[f], err_msg=f"{what} {f}")
    np.testing.assert_allclose(got.dense.numpy(), want_ints["dense"], rtol=1e-6,
                               err_msg=f"{what} dense")
    if dense is not None:
        assert torch.equal(got.dense, dense), f"{what}: dense differs from the port's engine"


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_row_parallel_matches_single_device(data, route, n_shards):
    """flatten_sharded(run_scan) and build_vocab_scan equal the JAX
    single-device engine on the same chunk sequence, padding rows and pad
    chunks included; dense bit for bit against the port's own."""
    feed, fields = ROUTES[route]
    stacks, offsets, flat = _feed(data, feed, n_shards)
    cfg = _port_config(feed, **fields)
    eng = TSP.ShardedPiperPipeline(cfg, tmesh.make_data_mesh(n_shards, device="cpu"))
    assert eng.n_shards == n_shards
    cs, os_ = tsharding.put_shard_feed(stacks, offsets, eng.mesh)
    got = TSP.flatten_sharded(eng.run_scan(cs, os_))
    single = TP.flatten_processed(TP.PiperPipeline(cfg).run_scan(flat))
    want, table, sizes = _jax_single(feed, flat)
    _assert_batch(got, want, f"{route} shards={n_shards}", dense=single.dense)
    voc = eng.build_vocab_scan(cs, os_)
    np.testing.assert_array_equal(voc.table.numpy(), table)
    np.testing.assert_array_equal(voc.sizes.numpy(), sizes)


_JAX_STATE = {}  # feed → the JAX engine's loop-① state with counts


def _jax_state(data, feed):
    """JAX build_state_stream over the feed's chunks, with the count plane,
    once per feed (pad chunks leave a state as it is, which the sharded
    runs check at every shard count)."""
    if feed not in _JAX_STATE:
        _, _, flat = _feed(data, feed, 1)
        if feed == "utf8":
            chunks = [jnp.asarray(c) for c in flat]
        else:
            chunks = [{k: jnp.asarray(v[i]) for k, v in flat.items()}
                      for i in range(len(flat["label"]))]
        jpipe = JP.PiperPipeline(JP.PipelineConfig(
            chunk_bytes=CHUNK_BYTES, max_rows_per_chunk=MAX_ROWS, input_format=feed,
            use_fused_kernel=False, track_vocab_counts=True))
        st = jpipe.build_state_stream(chunks)
        _JAX_STATE[feed] = tuple(np.asarray(x) for x in (st.first_pos, st.rows_seen, st.counts))
    return _JAX_STATE[feed]


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("feed", ["utf8", "binary"])
def test_row_parallel_counts_match_build_state_stream(data, feed, n_shards):
    """With the count plane, the merged state equals the JAX engine's
    build_state_stream over the feed: first_pos, rows_seen, counts."""
    stacks, offsets, flat = _feed(data, feed, n_shards)
    eng = TSP.ShardedPiperPipeline(_port_config(feed, track_vocab_counts=True),
                                   tmesh.make_data_mesh(n_shards, device="cpu"))
    got = interop.vocab_state_to_numpy(eng.build_state_scan(stacks, offsets))
    want = _jax_state(data, feed)
    for g, w, name in zip(got, want, ("first_pos", "rows_seen", "counts")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[1]) == ROWS


def test_shard_states_have_their_own_storage(data):
    """Every shard's state, and the stack the merge tree reduces, own their
    storage: the loop-① kernels update a state in place."""
    stacks, offsets, _ = _feed(data, "utf8", 4)
    eng = TSP.ShardedPiperPipeline(_port_config("utf8", track_vocab_counts=True),
                                   tmesh.make_data_mesh(4, device="cpu"))
    states = eng.shard_states(stacks, offsets)
    ptrs = [t.untyped_storage().data_ptr() for s in states for t in (s.first_pos, s.counts)]
    stacked = TSP.stack_states(states, torch.device("cpu"))
    ptrs.append(stacked.first_pos.untyped_storage().data_ptr())
    assert len(set(ptrs)) == len(ptrs)
    assert sum(int(s.rows_seen) for s in states) == ROWS


# --------------------------------------------------------------------- #
# both engines against the JAX package's sharded engines (4 host devices)
# --------------------------------------------------------------------- #

_JAX_SHARDED = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.data import synth, loader
from repro.core import pipeline as P, sharded_pipeline as SP, sharded as Sh
from repro.launch.mesh import make_mesh, make_data_mesh
from repro.distributed.sharding import put_shard_feed

buf, _ = synth.make_dataset(synth.SynthConfig(rows=%(rows)d, seed=%(seed)d))
pc = P.PipelineConfig(chunk_bytes=%(cb)d, max_rows_per_chunk=%(mr)d)
out = {}
for n in (2, 4):
    mesh = make_data_mesh(n)
    stacks, offsets = loader.TabularChunkFeed(buf, %(cb)d, n).shard_stacks()
    eng = SP.ShardedPiperPipeline(pc, mesh)
    cs, os_ = put_shard_feed(jnp.asarray(stacks), jnp.asarray(offsets), mesh)
    st = eng.build_state_scan(cs, os_)
    out[f"rows{n}/first_pos"] = np.asarray(st.first_pos)
    out[f"rows{n}/rows_seen"] = np.asarray(st.rows_seen)
    res = eng.run_scan(cs, os_)
    for f in ("label", "dense", "sparse", "valid"):
        out[f"rows{n}/{f}"] = np.asarray(getattr(res, f))
for shape, axes in %(meshes)r:
    mesh = make_mesh(shape, axes)
    eng = Sh.ShardedPiper(pc, mesh)
    feed = loader.TabularChunkFeed(buf, %(cb)d, eng.n_row_shards)
    key = "x".join(map(str, shape))
    with mesh:
        chunks, offs = jnp.asarray(feed.stacked), jnp.asarray(feed.offsets)
        state = jax.jit(lambda c, o: jax.lax.scan(
            lambda s, xs: (eng.vocab_step(s, *xs), None), eng.init_state(), (c, o))[0])(
                chunks, offs)
        voc = eng.finalize(state)
        res = eng.run_scan(chunks, offs)
    out[f"cols{key}/state"] = np.asarray(state)
    out[f"cols{key}/table"] = np.asarray(voc.table)
    out[f"cols{key}/sizes"] = np.asarray(voc.sizes)
    for f in ("label", "dense", "sparse", "valid"):
        out[f"cols{key}/{f}"] = np.asarray(getattr(res, f))
np.savez(sys.argv[1] if len(sys.argv) > 1 else %(path)r, **out)
print("OK")
"""

COL_MESHES = (((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
              ((2, 1, 2), ("pod", "data", "model")))


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded engines' states and outputs, from one
    subprocess with 4 forced host devices."""
    path = str(tmp_path_factory.mktemp("jax_sharded") / "ref.npz")
    code = _JAX_SHARDED % {"rows": ROWS, "seed": SEED, "cb": CHUNK_BYTES, "mr": MAX_ROWS,
                           "meshes": COL_MESHES, "path": path}
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_row_parallel_matches_jax_sharded_pipeline(data, jax_sharded, n_shards):
    """build_state_scan's merged state and run_scan's [n_shards, n_steps,
    rows, ...] outputs equal the JAX ShardedPiperPipeline's."""
    stacks, offsets, _ = _feed(data, "utf8", n_shards)
    eng = TSP.ShardedPiperPipeline(_port_config("utf8"),
                                   tmesh.make_data_mesh(n_shards, device="cpu"))
    st = eng.build_state_scan(stacks, offsets)
    ref = {k.split("/")[1]: v for k, v in jax_sharded.items() if k.startswith(f"rows{n_shards}/")}
    np.testing.assert_array_equal(st.first_pos.numpy(), ref["first_pos"])
    np.testing.assert_array_equal(st.rows_seen.numpy(), ref["rows_seen"])
    _assert_batch(eng.run_scan(stacks, offsets), ref, f"rows{n_shards}")


@pytest.mark.parametrize("shape,axes", COL_MESHES, ids=lambda x: "x".join(map(str, x)))
def test_column_parallel_matches_jax_sharded_piper(data, jax_sharded, shape, axes):
    """ShardedPiper's stacked per-shard state, its vocabulary and its
    run_scan outputs (padding columns included) equal the JAX
    ShardedPiper's; on the valid rows and the first 26 columns the outputs
    equal the port's single-device engine."""
    buf, _ = data
    key = "cols" + "x".join(map(str, shape))
    ref = {k.split("/")[1]: v for k, v in jax_sharded.items() if k.startswith(key + "/")}
    cfg = _port_config("utf8")
    eng = TSh.ShardedPiper(cfg, tmesh.make_mesh(shape, axes, devices="cpu"))
    feed = tloader.TabularChunkFeed(buf, CHUNK_BYTES, eng.n_row_shards)
    state = eng.init_state()
    for i in range(feed.n_steps):
        state = eng.vocab_step(state, feed.stacked[i], feed.offsets[i])
    np.testing.assert_array_equal(eng.stacked_state(state).numpy(), ref["state"])
    voc = eng.stacked_vocabulary(eng.finalize(state))
    np.testing.assert_array_equal(voc.table.numpy(), ref["table"])
    np.testing.assert_array_equal(voc.sizes.numpy(), ref["sizes"])
    out = eng.run_scan(feed.stacked, feed.offsets)
    _assert_batch(out, ref, key)
    assert not out.sparse[..., eng.schema.n_sparse:].any()  # padding columns: 0
    single = TP.flatten_processed(TP.PiperPipeline(cfg).run_scan(
        feed.stacked.reshape(-1, CHUNK_BYTES)))
    v = out.valid.reshape(-1)
    assert torch.equal(v, single.valid)
    assert torch.equal(out.sparse.reshape(-1, eng.cols_pad)[v, :eng.schema.n_sparse],
                       single.sparse[v])
    assert torch.equal(out.dense.reshape(-1, eng.schema.n_dense)[v], single.dense[v])


# --------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------- #

def _raises_cases():
    cpu = dict(devices="cpu")
    cfg = _port_config("utf8")
    feed = lambda n: (np.zeros((n, 1, CHUNK_BYTES), np.uint8),  # noqa: E731
                      np.zeros((n, 1), np.int32))
    return {
        "feed_shards_mismatch": (ValueError, "feed has 2 shard stacks but the mesh has 4",
                                 lambda: TSP.ShardedPiperPipeline(
                                     cfg, tmesh.make_data_mesh(4, device="cpu")
                                 ).build_state_scan(*feed(2))),
        "put_shard_feed_mismatch": (ValueError, "n_row_shards=3", lambda: tsharding.put_shard_feed(
            *feed(2), tmesh.make_data_mesh(3, device="cpu"))),
        "no_row_axis": (ValueError, "no 'data'/'pod' axis", lambda: TSP.ShardedPiperPipeline(
            cfg, tmesh.make_mesh((2,), ("model",), **cpu))),
        "no_model_axis": (ValueError, "no 'model' axis", lambda: TSh.ShardedPiper(
            cfg, tmesh.make_mesh((2,), ("data",), **cpu))),
        "plan": (ValueError, "default Criteo chain", lambda: TSh.ShardedPiper(
            dataclasses.replace(cfg, plan=tplan.crossed_criteo()),
            tmesh.make_mesh((1, 2), ("data", "model"), **cpu))),
        "counts": (ValueError, "count plane", lambda: TSh.ShardedPiper(
            dataclasses.replace(cfg, track_vocab_counts=True),
            tmesh.make_mesh((1, 2), ("data", "model"), **cpu))),
        "binary": (ValueError, "input_format='binary'", lambda: TSh.ShardedPiper(
            dataclasses.replace(cfg, input_format="binary"),
            tmesh.make_mesh((1, 2), ("data", "model"), **cpu))),
        "mesh_shape": (ValueError, "do not pair up", lambda: tmesh.make_mesh(
            (2, 2), ("data",), **cpu)),
        "mesh_devices": (ValueError, "3 devices for a mesh of 4", lambda: tmesh.make_mesh(
            (4,), ("data",), devices=["cpu"] * 3)),
    }


@pytest.mark.parametrize("case", list(_raises_cases()))
def test_sharded_engines_refuse(case):
    exc, match, fn = _raises_cases()[case]
    with pytest.raises(exc, match=match):
        fn()


def test_default_plan_is_accepted_by_sharded_piper():
    cfg = dataclasses.replace(_port_config("utf8"), plan=tplan.criteo_default())
    eng = TSh.ShardedPiper(cfg, tmesh.make_mesh((1, 4), ("data", "model"), devices="cpu"))
    assert (eng.cols_pad, eng.cols_local) == (28, 7)


def test_mesh_positions_are_row_major():
    """DeviceMesh.along flattens its axes first-major, the other axes at 0,
    as the reference's PartitionSpec(('pod', 'data')) orders its shards."""
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devs)
    assert tmesh.data_axes(mesh) == ("pod", "data")
    assert mesh.along(("pod", "data")) == [devs[0], devs[2], devs[4], devs[6]]
    assert mesh.along(("pod", "data"), model=1) == [devs[1], devs[3], devs[5], devs[7]]
    assert mesh.device(pod=1, model=1) == devs[5]
    assert mesh.distinct_devices() == devs
    assert dict(mesh.shape) == {"pod": 2, "data": 2, "model": 2}
    placed = tsharding.replicated(
        tvocab.Vocabulary(table=torch.zeros(2, 3, dtype=torch.int32),
                          sizes=torch.zeros(2, dtype=torch.int32)),
        tmesh.make_data_mesh(4, device="cpu"))
    assert list(placed) == [torch.device("cpu")]


# --------------------------------------------------------------------- #
# all_reduce_state over gloo, one process per instance
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_state_over_gloo(data, world, tmp_path):
    """Each of ``world`` processes builds its shard's local state and calls
    all_reduce_state; every rank ends with the single-process
    build_state_scan's merged state, counts included, bit for bit."""
    stacks, offsets, _ = _feed(data, "utf8", world)
    eng = TSP.ShardedPiperPipeline(_port_config("utf8", track_vocab_counts=True),
                                   tmesh.make_data_mesh(world, device="cpu"))
    want = interop.vocab_state_to_numpy(eng.build_state_scan(stacks, offsets))
    for got in run_ranks(world, stacks, offsets, tmp_path, chunk_bytes=CHUNK_BYTES,
                         max_rows=MAX_ROWS):
        for name, w in zip(("first_pos", "rows_seen", "counts"), want):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
