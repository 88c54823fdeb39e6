"""The port's sharding rules (repro_torch/distributed/sharding.py) against
the JAX package's, and its blocks.

For every architecture of ``configs.ARCH_IDS`` at its published size and
for the DLRM's CONFIG_5K and CONFIG_1M, on meshes (2, 4), (16, 16) and
(2, 16, 16): every parameter's and AdamW moment's spec, every decode-state
leaf's spec and the spec ``constraint_spec`` gives each kind equal the
reference's, computed on a ``jax.sharding.AbstractMesh`` (no devices, no
subprocess). The reference stacks each layer spec on a leading
``n_superblocks`` axis; a port leaf holds one layer, so its spec is the
reference's without that leading None. The port's trees are made on the
``meta`` device (no memory). Then ``make_production_mesh``, ``constrain``,
and ``shard`` / ``unshard``: blocks are views where positions share a
device, ``unshard`` is their exact inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import piper_dlrm as jdlrm_cfg
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import dlrm as jdlrm
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import piper_dlrm as tdlrm_cfg
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import leaves_with_paths

MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCH, CACHE_LEN = 32, 64


def _meshes(name):
    shape, axes = MESHES[name]
    return (jax.sharding.AbstractMesh(shape, axes),
            tmesh.make_mesh(shape, axes, devices="cpu"))


def _ref_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                    for p in path)


def _ref_specs(tree, spec_fn) -> dict:
    """{path: spec} of a reference tree of ShapeDtypeStructs."""
    return {_ref_key(path): spec_fn(path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_path(path: tuple, stacked: tuple[str, ...]) -> tuple[tuple, bool]:
    """A port leaf's path in the reference's tree: a ``blocks`` list's
    ``[superblock][spec]`` becomes the stacked ``[spec]``. Returns (path,
    whether the reference leaf carries the stacked axis)."""
    out, i = [], 0
    while i < len(path):
        out.append(path[i])
        if path[i] in stacked and i + 2 < len(path):
            out.append(path[i + 2])  # the spec index; the superblock index is the stacked axis
            out.extend(path[i + 3:])
            return tuple(out), True
        i += 1
    return tuple(out), False


def _same(port_tree, ref_specs: dict, port_spec, stacked=("blocks",)) -> None:
    """Every port leaf's spec equals its reference leaf's, and every
    reference leaf has a port leaf."""
    seen = set()
    for path, leaf in leaves_with_paths(port_tree):
        ref_path, is_stacked = _ref_path(path, stacked)
        key = "/".join(ref_path)
        want = tuple(ref_specs[key])[1:] if is_stacked else tuple(ref_specs[key])
        got = port_spec(path, leaf)
        assert got == tsharding.PartitionSpec(*want), (path, got, want)
        seen.add(key)
    assert seen == set(ref_specs)


_SKELETONS = {}


def _lm_skeletons(arch):
    """(reference ShapeDtypeStruct params, the port's meta params) at the
    published size."""
    if arch not in _SKELETONS:
        jmodel = jspecs.build_model(jconfigs.get(arch))
        _SKELETONS[arch] = (jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                            interop._lm_skeleton(tconfigs.get(arch)))
    return _SKELETONS[arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_and_adamw_specs_match_the_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jparams, tparams = _lm_skeletons(arch)
    for jtree, ttree in ((jparams, tparams),
                         (jax.eval_shape(jopt.adamw_init, jparams), topt.adamw_init(tparams))):
        ref = _ref_specs(jtree, lambda p, leaf: jsharding.spec_for_path(p, leaf, jm))
        shardings = dict(leaves_with_paths(tsharding.param_shardings(ttree, tm)))
        _same(ttree, ref, lambda p, _: shardings[p].spec)
        assert all(s.mesh is tm for s in shardings.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("config", ["CONFIG_5K", "CONFIG_1M"])
def test_dlrm_specs_match_the_reference(config, mesh_name, monkeypatch):
    """The DLRM's per-table (columnar) rule: its tables, MLPs and AdamW
    state, the port's tree made on the meta device."""
    jm, tm = _meshes(mesh_name)
    jcfg = getattr(jdlrm_cfg, config).model
    jparams = jax.eval_shape(lambda: jdlrm.init(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(tdlrm, "_resolve_device", lambda d: torch.device("meta"))
    tparams = tdlrm.DLRM(getattr(tdlrm_cfg, config).model, device="meta").params_tree()
    for jtree, ttree in ((jparams, tparams),
                         (jax.eval_shape(jopt.adamw_init, jparams), topt.adamw_init(tparams))):
        ref = _ref_specs(jtree, lambda p, leaf: jsharding.spec_for_path(p, leaf, jm))
        _same(ttree, ref, lambda p, leaf: tsharding.spec_for_path(p, leaf, tm))


def _decoder(arch):
    cfg = jconfigs.get(arch)
    jmodel = jspecs.build_model(cfg)
    jmodel = jmodel.decoder if cfg.family == "audio" else jmodel
    return jmodel, tlm.LM(tconfigs.get(arch), device="meta")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_specs_match_the_reference(arch, mesh_name):
    """cache_shardings of the decode state (KV caches, rings' slot_pos,
    SSM states, cross layers' context caches), batch 32, cache 64."""
    jm, tm = _meshes(mesh_name)
    jmodel, tmodel = _decoder(arch)
    jstate = jax.eval_shape(lambda: jmodel.init_decode_state(CACHE_BATCH, CACHE_LEN))
    ref = {_ref_key(p): s.spec for p, s in
           jax.tree_util.tree_flatten_with_path(jsharding.cache_shardings(jstate, jm))[0]}
    tstate = tmodel.init_decode_state(CACHE_BATCH, CACHE_LEN)
    shardings = dict(leaves_with_paths(tsharding.cache_shardings(tstate, tm)))
    seen = set()
    for path, _ in leaves_with_paths(tstate):
        key = "/".join(path[1:])  # [superblock][spec] → the stacked [spec]
        want = tuple(ref[key])[1:]
        assert shardings[path].spec == tsharding.PartitionSpec(*want), (path, want)
        seen.add(key)
    assert seen == set(ref)


# (kind, shapes): legal and illegal dims on each mesh
CONSTRAINT_SHAPES = {
    "act": [(32, 16, 64), (6, 5, 64)], "ffn": [(32, 8, 256), (32, 8, 24)],
    "heads": [(32, 16, 8, 64), (32, 12, 8, 64)], "experts": [(64, 8, 32), (60, 8, 32)],
    "logits": [(32, 8, 1024), (32, 8, 1001)], "batch": [(64,), (64, 3), (7, 3, 2)],
}


@pytest.mark.parametrize("sequence_parallel", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constraint_specs_match_the_reference(mesh_name, sequence_parallel, monkeypatch):
    """constraint_spec of every kind against the sharding the reference's
    constrain passes to with_sharding_constraint (caught by a stand-in);
    None and the input itself outside use_mesh."""
    jm, tm = _meshes(mesh_name)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, sh: sh)
    for kind, shapes in CONSTRAINT_SHAPES.items():
        for shape in shapes:
            x = torch.empty(shape, device="meta")
            assert tsharding.constraint_spec(x, kind) is None
            assert tsharding.constrain(x, kind) is x
            with jsharding.use_mesh(jm, sequence_parallel):
                want = jsharding.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), kind).spec
            with tsharding.use_mesh(tm, sequence_parallel):
                assert tsharding.constraint_spec(x, kind) == tsharding.PartitionSpec(*want), \
                    (kind, shape)
                assert tsharding.constrain(x, kind) is x
                assert tsharding.current_mesh() is tm
            assert tsharding.current_mesh() is None
    with pytest.raises(ValueError, match="unknown constraint kind"):
        tsharding.constraint_spec(torch.empty((2, 2)), "rows")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_activation_logits_feed_specs_match_the_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    P = tsharding.PartitionSpec
    for rank in (1, 2, 3):
        assert tsharding.batch_spec(tm, rank) == P(*jsharding.batch_spec(jm, rank))
        assert tsharding.shard_feed_spec(tm, rank) == P(*jsharding.shard_feed_spec(jm, rank))
    for sp in (False, True):
        assert tsharding.activation_spec(tm, sp) == P(*jsharding.activation_spec(jm, sp))
    assert tsharding.logits_spec(tm) == P(*jsharding.logits_spec(jm))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference(multi_pod, monkeypatch):
    """The reference's make_production_mesh asks make_mesh for its shape
    and axes (caught by a stand-in: this process has one device)."""
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: (shape, axes))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    m = tmesh.make_production_mesh(multi_pod=multi_pod, devices="cpu")
    assert m.axis_names == axes and tuple(m.shape.values()) == shape
    assert len(m.devices) == int(np.prod(shape)) and m.distinct_devices() == [torch.device("cpu")]


def test_production_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_production_mesh()


def test_partition_spec_normalises_one_name_tuples():
    P = tsharding.PartitionSpec
    assert P(None, ("data",), "model") == P(None, "data", "model")
    assert P(("pod", "data")) != P("data")
    assert P(None, "a") != P(None, "a", None)
    assert hash(P(("data",))) == hash(P("data"))
    m = tmesh.make_mesh((2, 4), ("data", "model"), devices="cpu")
    assert tsharding.NamedSharding(m, P(("data",))) == tsharding.NamedSharding(m, P("data"))


SPECS = [(), (None, None), ("model",), ("data", "model"), (("data", "model"), None),
         (None, ("model", "data")), ("model", "data")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_blocks_are_views_and_unshard_inverts_them(spec):
    """Each position's block is its slice of the tensor (the flattened
    index of its axes, the first major), a view of the tensor itself;
    unshard gives back a view of the same memory, and the exact tensor
    from copies of the blocks."""
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices="cpu")
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    sh = tsharding.NamedSharding(mesh, tsharding.PartitionSpec(*spec))
    blocks = tsharding.shard(x, sh)
    ranges = tsharding.block_ranges(sh, x.shape)
    for pos, b in enumerate(blocks):
        assert b.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        (r0, n0), (r1, n1) = ranges[pos]
        assert torch.equal(b, x[r0:r0 + n0, r1:r1 + n1])
    whole = tsharding.unshard(blocks, sh)
    assert whole.data_ptr() == x.data_ptr() and torch.equal(whole, x)
    copied = tsharding.unshard([b.clone() for b in blocks], sh)
    assert copied.data_ptr() != x.data_ptr() and torch.equal(copied, x)
    st = tsharding.ShardedTensor.of(x, sh)
    assert st.shape == (8, 16) and torch.equal(st.full(), x)


def test_shard_places_blocks_on_their_positions_devices():
    """A mesh whose positions name devices: each block on its position's
    device, one copy per distinct device."""
    devs = ["cpu", "meta", "cpu", "meta"]
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=devs)
    x = torch.arange(16.0).reshape(4, 4)
    blocks = tsharding.shard(x, tsharding.NamedSharding(mesh, tsharding.PartitionSpec("data")))
    assert [b.device.type for b in blocks] == devs
    assert blocks[0].data_ptr() == x.data_ptr() and torch.equal(blocks[2], x[2:])


def test_shard_refuses_an_uneven_split():
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices="cpu")
    with pytest.raises(ValueError, match="evenly"):
        tsharding.shard(torch.zeros(6, 3), tsharding.NamedSharding(
            mesh, tsharding.PartitionSpec("model")))
    with pytest.raises(ValueError, match="more entries"):
        tsharding.shard(torch.zeros(8), tsharding.NamedSharding(
            mesh, tsharding.PartitionSpec("model", None)))
