"""Sharding rules and placement: parameters, activations, caches, feeds.

Counterpart of ``repro/distributed/sharding.py``. The strategy is the
reference's FSDP(+pod) × TP(+EP), Megatron-style:

  * column-parallel projections (wq/wk/wv, gate/up, in_proj, w_x): output
    dim → ``model``, input dim → FSDP over ``('pod', 'data')``;
  * row-parallel projections (wo, down, out_proj): input dim → ``model``,
    output dim → FSDP;
  * embeddings: vocab → ``model``, d_model → FSDP;
  * MoE experts: expert dim → ``model`` (expert parallelism), inner dims
    FSDP where legal;
  * SSM channel dims (d_inner) → ``model``;
  * everything 1-D (norm scales, biases of row-parallel layers):
    replicated.

Rules match on path *suffixes* of a tree (``train/tree.py``: dict keys,
list indices, which the match skips) and give the spec of the TRAILING
dims; leading dims are padded with None. The reference stacks each layer
spec on a leading ``n_superblocks`` axis; the port's trees hold one
tensor per layer, so a port leaf's spec is the reference's without its
leading None. The same rules give the AdamW state's specs (``m`` and
``v`` match the parameters' suffixes; ``step`` replicates) and, through
:func:`cache_shardings`, the decode state's.

Specs are :class:`PartitionSpec` tuples and a placement a
:class:`NamedSharding` over a :class:`~repro_torch.launch.mesh.DeviceMesh`.
:func:`shard` cuts a tensor into one block per mesh position and
:func:`unshard` puts them back; where positions share a device the blocks
are views of one tensor, so a sharded tree on one card takes no more
memory than the whole tree.

:func:`use_mesh` sets the mesh that the MoE layer's expert-parallel path
reads (``models/mlp.py``). :func:`constrain` returns its input itself: the
reference's ``with_sharding_constraint`` is a layout hint to its compiler
and never changes a value, and one process here computes whole tensors,
so the model code carries no such calls; :func:`constraint_spec` gives
the legalized spec the reference would apply.

The feed half places the row-parallel engine's feed and its read-only
vocabulary. The feed layout is fixed by ``TabularChunkFeed.shard_stacks``
and ``BinaryChunkFeed.shard_stacks``: leading axis = row shard, second
axis = chunk step. Shard ``k``'s stack lives on the device of row shard
``k`` for the whole epoch; the finalized vocabulary is the only array
copied to every device (it is read-only in loop ②).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.launch.mesh import DeviceMesh, data_axes
from repro_torch.train.tree import tree_map_with_path

Params = Any


# --------------------------------------------------------------------- #
# specs and placements
# --------------------------------------------------------------------- #
def _entry(axis):
    """The reference's normalisation of one dim's entry: a 1-tuple of
    names is that name."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    names (the dim split over their flattened product, the first major).
    Equal to another spec when their normalised entries are equal
    (``("data",)`` on a dim equals ``"data"``). Not a tree leaf: a spec
    lives inside a :class:`NamedSharding`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def normalized(self) -> tuple:
        return tuple(_entry(e) for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self.normalized() == PartitionSpec(*other).normalized()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self.normalized())

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class NamedSharding:
    """A spec over a mesh: the placement of a tensor as one block per
    mesh position."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((self.mesh.axis_names, self.spec))

    def __repr__(self):
        return f"NamedSharding(axes={self.mesh.axis_names}, shape={dict(self.mesh.shape)}, " \
               f"spec={self.spec!r})"


# suffix → trailing-dims spec (the FSDP placeholder "F" resolved per mesh),
# rule for rule the reference's
_RULES: list[tuple[tuple[str, ...], tuple[Any, ...]]] = [
    # embeddings / heads
    (("embed",), ("model", "F")),
    (("pos_embed",), (None, "F")),
    (("lm_head", "w"), ("F", "model")),
    (("lm_head", "b"), ("model",)),
    # attention (column-parallel qkv, row-parallel o)
    (("attn", "wq", "w"), ("F", "model")),
    (("attn", "wk", "w"), ("F", "model")),
    (("attn", "wv", "w"), ("F", "model")),
    (("attn", "wq", "b"), ("model",)),
    (("attn", "wk", "b"), ("model",)),
    (("attn", "wv", "b"), ("model",)),
    (("attn", "wo", "w"), ("model", "F")),
    (("attn", "wo", "b"), (None,)),
    # dense MLP
    (("mlp", "gate", "w"), ("F", "model")),
    (("mlp", "up", "w"), ("F", "model")),
    (("mlp", "down", "w"), ("model", "F")),
    (("mlp", "gate", "b"), ("model",)),
    (("mlp", "up", "b"), ("model",)),
    (("mlp", "down", "b"), (None,)),
    # MoE (expert-parallel)
    (("mlp", "w_gate"), ("model", "F", None)),
    (("mlp", "w_up"), ("model", "F", None)),
    (("mlp", "w_down"), ("model", None, "F")),
    (("mlp", "router", "w"), ("F", None)),
    (("mlp", "shared", "gate", "w"), ("F", "model")),
    (("mlp", "shared", "up", "w"), ("F", "model")),
    (("mlp", "shared", "down", "w"), ("model", "F")),
    # mamba
    (("mamba", "in_proj", "w"), ("F", "model")),
    (("mamba", "out_proj", "w"), ("model", "F")),
    (("mamba", "w_bcdt", "w"), ("model", None)),
    (("mamba", "dt_bias"), ("model",)),
    (("mamba", "a_log"), ("model", None)),
    (("mamba", "d_skip"), ("model",)),
    # mLSTM / sLSTM
    (("mlstm", "wq", "w"), ("F", "model")),
    (("mlstm", "wk", "w"), ("F", "model")),
    (("mlstm", "wv", "w"), ("F", "model")),
    (("mlstm", "wo", "w"), ("model", "F")),
    (("mlstm", "w_gates", "w"), ("F", None)),
    (("slstm", "w_x", "w"), ("F", "model")),
    (("slstm", "wo", "w"), ("model", "F")),
    (("slstm", "r_h"), (None, None, None)),
    # DLRM: per-table (columnar) sharding, as the vocab engine's
    (("tables",), ("model", None, "F")),
]


def _path_names(path) -> tuple[str, ...]:
    """A path of ``train/tree.py`` (keys, list indices, field names) as
    strings."""
    return tuple(str(p) for p in path)


def _match(names: tuple[str, ...], suffix: tuple[str, ...]) -> bool:
    """``suffix`` is the tail of ``names`` with the list indices left out
    (layer paths carry indices between the matched names)."""
    filtered = tuple(n for n in names if not n.isdigit())
    return filtered[-len(suffix):] == suffix if len(filtered) >= len(suffix) else False


def _rank(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)


def spec_for_path(path, leaf, mesh: DeviceMesh) -> PartitionSpec:
    """The spec of the leaf at ``path`` (anything with ``.shape``): the
    first rule whose suffix matches, padded with None to the leaf's rank
    and legalized; replicated where no rule matches."""
    names = _path_names(path)
    fsdp = data_axes(mesh)
    rank = _rank(leaf)
    for suffix, trailing in _RULES:
        if _match(names, suffix):
            spec = [None] * (rank - len(trailing)) + [fsdp if t == "F" else t for t in trailing]
            return PartitionSpec(*_legalize(spec, tuple(leaf.shape), mesh))
    return PartitionSpec()  # replicated (norm scales, small vectors)


def _axis_size(axis, mesh: DeviceMesh) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _legalize(spec: list, shape: tuple[int, ...], mesh: DeviceMesh) -> list:
    """Drop (replicate) every axis that does not split its dim evenly or
    has size 1; as the reference's, the spec is cut to the shape's rank."""
    out = []
    for dim, axis in zip(shape, spec):
        n = _axis_size(axis, mesh)
        out.append(axis if n > 1 and dim % n == 0 else None)
    return out


def param_shardings(params: Params, mesh: DeviceMesh) -> Params:
    """A tree of :class:`NamedSharding` matching ``params`` (tensors,
    arrays, anything with ``.shape``; ``meta`` tensors too), one per leaf
    by :func:`spec_for_path`. On an AdamW state it gives ``m`` and ``v``
    the parameters' specs and ``step`` a replicated one."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for_path(path, leaf, mesh)), params)


def batch_spec(mesh: DeviceMesh, rank: int = 2) -> PartitionSpec:
    """tokens [GB, S] / token [GB]: batch over ``('pod', 'data')``."""
    return PartitionSpec(data_axes(mesh), *([None] * (rank - 1)))


def activation_spec(mesh: DeviceMesh, sequence_parallel: bool = False) -> PartitionSpec:
    """[B, S, d] activations (sequence parallelism shards S over
    ``model``)."""
    if sequence_parallel:
        return PartitionSpec(data_axes(mesh), "model", None)
    return PartitionSpec(data_axes(mesh), None, None)


def cache_shardings(state: Params, mesh: DeviceMesh) -> Params:
    """Decode-state shardings. A port leaf is one layer's ``[B, heads or
    channels, seq, head_dim]`` (the reference's without its leading
    ``n_superblocks`` axis): batch (axis 0) → data axes; ``model`` on the
    first inner axis it divides, heads or channels (axis 1) preferred, else
    the sequence (axis 2), the KV-sequence layout for head counts the
    model axis does not divide. Ring ``slot_pos`` leaves replicate."""
    dp = data_axes(mesh)
    msize = mesh.shape["model"]

    def spec(path, leaf):
        names = _path_names(path)
        rank = _rank(leaf)
        if names and names[-1] == "slot_pos":
            return NamedSharding(mesh, PartitionSpec())
        s: list = [None] * rank
        if rank >= 1:
            s[0] = dp
        for axis in range(1, rank):
            if leaf.shape[axis] % msize == 0:
                s[axis] = "model"
                break
        return NamedSharding(mesh, PartitionSpec(*_legalize(s, tuple(leaf.shape), mesh)))

    return tree_map_with_path(spec, state)


def logits_spec(mesh: DeviceMesh) -> PartitionSpec:
    return PartitionSpec(data_axes(mesh), None, "model")


def shard_feed_spec(mesh: DeviceMesh, rank: int = 3) -> PartitionSpec:
    """Per-shard chunk stacks ``[n_shards, n_steps, ...]``: the shard axis
    over ``('pod', 'data')``, as :func:`batch_spec` (a feed shard is a
    batch shard)."""
    return batch_spec(mesh, rank)


# --------------------------------------------------------------------- #
# the mesh context
# --------------------------------------------------------------------- #
_MESH_CTX: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_SP_CTX: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_sequence_parallel", default=False)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None, sequence_parallel: bool = False):
    """Make ``mesh`` the current mesh inside the block: MoE layers whose
    expert count the ``model`` axis divides take the expert-parallel
    path."""
    t1 = _MESH_CTX.set(mesh)
    t2 = _SP_CTX.set(sequence_parallel)
    try:
        yield
    finally:
        _MESH_CTX.reset(t1)
        _SP_CTX.reset(t2)


def current_mesh() -> DeviceMesh | None:
    """The active :func:`use_mesh` mesh (None outside one)."""
    return _MESH_CTX.get()


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation in
    the backward runs under the mesh context its forward ran under. The
    autograd engine runs a CUDA backward on a thread of its own, where
    these context variables are unset, so a remat block with an MoE layer
    would otherwise recompute on the dense path."""
    return contextlib.nullcontext(), use_mesh(_MESH_CTX.get(), _SP_CTX.get())


_CONSTRAINT_KINDS = ("act", "ffn", "heads", "experts", "logits", "batch")


def constraint_spec(x, kind: str) -> PartitionSpec | None:
    """The legalized spec the reference's ``constrain(x, kind)`` applies
    under the current mesh, or None outside :func:`use_mesh`.

    kinds: 'act' [B,S,d] · 'ffn' [B,S,ff] · 'heads' [B,H,S,D] ·
    'experts' [E,C,d] · 'logits' [B,S,V] · 'batch' [B,...]
    """
    if kind not in _CONSTRAINT_KINDS:
        raise ValueError(f"unknown constraint kind {kind!r}; kinds are {_CONSTRAINT_KINDS}")
    mesh = _MESH_CTX.get()
    if mesh is None:
        return None
    dp = data_axes(mesh)
    seq = "model" if _SP_CTX.get() else None
    rank = _rank(x)
    specs = {
        # sequence parallelism shards only the residual stream's sequence;
        # the tensor-parallel regions shard their own inner dim
        "act": [dp, seq, None],
        "ffn": [dp, None, "model"],
        "heads": [dp, "model", None, None],
        "experts": ["model", None, None],
        "logits": [dp, None, "model"],
        "batch": [dp] + [None] * (rank - 1),
    }
    return PartitionSpec(*_legalize(specs[kind][:rank], tuple(x.shape), mesh))


def constrain(x, kind: str):
    """``x`` itself: a layout hint never changes a value, and one process
    holds whole tensors (see the module docstring)."""
    constraint_spec(x, kind)
    return x


# --------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------- #
def _coords(mesh: DeviceMesh, position: int) -> dict[str, int]:
    coords, rest = {}, position
    for a in reversed(mesh.axis_names):
        coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
    return coords


def _block_index(axis, coords: dict[str, int], mesh: DeviceMesh) -> int:
    if axis is None:
        return 0
    names = axis if isinstance(axis, tuple) else (axis,)
    k = 0
    for a in names:
        k = k * mesh.shape[a] + coords[a]
    return k


def _padded(sharding: NamedSharding, shape) -> list:
    spec = list(sharding.spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {sharding.spec} has more entries than a rank-{len(shape)} tensor")
    return spec + [None] * (len(shape) - len(spec))


def block_ranges(sharding: NamedSharding, shape) -> list[tuple[tuple[int, int], ...]]:
    """``(start, size)`` of each dim of each mesh position's block, row
    major over the mesh. Raises ``ValueError`` where an axis does not
    split its dim evenly."""
    mesh, spec = sharding.mesh, _padded(sharding, tuple(shape))
    for dim, axis in zip(shape, spec):
        if dim % _axis_size(axis, mesh):
            raise ValueError(f"spec {sharding.spec} does not split shape {tuple(shape)} evenly")
    out = []
    for pos in range(len(mesh.devices)):
        coords = _coords(mesh, pos)
        out.append(tuple(
            (_block_index(axis, coords, mesh) * (dim // _axis_size(axis, mesh)),
             dim // _axis_size(axis, mesh))
            for dim, axis in zip(shape, spec)))
    return out


def shard(x: torch.Tensor, sharding: NamedSharding) -> list[torch.Tensor]:
    """One block of ``x`` per mesh position, row major, each on its
    position's device. ``x`` is copied once to each device it is not on;
    blocks on one device are views of that copy (of ``x`` itself on its own
    device), never copies."""
    on: dict[torch.device, torch.Tensor] = {}
    blocks = []
    for dev, ranges in zip(sharding.mesh.devices, block_ranges(sharding, x.shape)):
        if dev not in on:
            on[dev] = x if x.device == dev else x.to(dev)
        b = on[dev]
        for dim, (start, size) in enumerate(ranges):
            b = b.narrow(dim, start, size)
        blocks.append(b)
    return blocks


def _global_shape(blocks, sharding: NamedSharding) -> tuple[int, ...]:
    spec = _padded(sharding, tuple(blocks[0].shape))
    return tuple(n * _axis_size(a, sharding.mesh) for n, a in zip(blocks[0].shape, spec))


def unshard(blocks: list[torch.Tensor], sharding: NamedSharding) -> torch.Tensor:
    """The tensor whose :func:`shard` ``blocks`` are, on the first
    position's device. Where every block is a view of one tensor on that
    device, that tensor's view is returned and nothing is copied;
    otherwise the blocks are copied into a new tensor."""
    if len(blocks) != len(sharding.mesh.devices):
        raise ValueError(f"{len(blocks)} blocks for a mesh of {len(sharding.mesh.devices)} "
                         "positions")
    shape = _global_shape(blocks, sharding)
    ranges = block_ranges(sharding, shape)
    first = blocks[0]
    dev = first.device
    if all(b.device == dev for b in blocks):
        stride, base = first.stride(), first.storage_offset()
        if all(b.stride() == stride
               and b.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
               and b.storage_offset() == base + sum(
                   (s - r0[0]) * st for (s, _), r0, st in zip(r, ranges[0], stride))
               for b, r in zip(blocks, ranges)):
            return first.as_strided(shape, stride, base)
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    for b, r in zip(blocks, ranges):
        view = out
        for dim, (start, size) in enumerate(r):
            view = view.narrow(dim, start, size)
        view.copy_(b)
    return out


class ShardedTensor:
    """A tensor held as the blocks of a :class:`NamedSharding` (one per
    mesh position, as :func:`shard` gives them). A tree leaf."""

    __slots__ = ("blocks", "sharding", "shape")

    def __init__(self, blocks: list[torch.Tensor], sharding: NamedSharding):
        self.blocks, self.sharding = blocks, sharding
        self.shape = _global_shape(blocks, sharding)

    @classmethod
    def of(cls, x, sharding: NamedSharding) -> "ShardedTensor":
        return cls(shard(x, sharding), sharding)

    def full(self) -> torch.Tensor:
        return unshard(self.blocks, self.sharding)


# --------------------------------------------------------------------- #
# the row-parallel engine's feed
# --------------------------------------------------------------------- #


def row_devices(mesh: DeviceMesh) -> list[torch.device]:
    """One device per row shard: the rows split over ``('pod', 'data')``,
    every other axis at position 0."""
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {mesh.axis_names} has no 'data'/'pod' axis to shard rows over")
    return mesh.along(axes)


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def put_stack(stack, device: torch.device):
    """One shard's stack (an array, or a dict of arrays) on ``device``, one
    copy per field; tensors already there are returned as they are."""
    if isinstance(stack, dict):
        return {k: _to(v, device) for k, v in stack.items()}
    return _to(stack, device)


def check_shard_count(chunks, n_shards: int) -> None:
    """Raise unless the feed (host arrays, or a placed per-shard list) has
    one stack per row shard."""
    lead = len(chunks["label"]) if isinstance(chunks, dict) else len(chunks)
    if lead != n_shards:
        raise ValueError(
            f"feed has {lead} shard stacks but the mesh has {n_shards} row shards; "
            f"build TabularChunkFeed with n_row_shards={n_shards}")


def put_shard_stacks(chunks, mesh: DeviceMesh) -> list:
    """Copy each shard's chunk stack to its row shard's device.

    ``chunks`` is a uint8 array ``[n_shards, n_steps, chunk_bytes]`` (the
    UTF-8 wire format) or a dict of arrays whose first axis is the shard
    axis (a binary feed). Returns shard ``k``'s stack (a tensor, or a dict)
    on row shard ``k``'s device: one copy per shard and field, none a
    chunk.
    """
    devs = row_devices(mesh)
    check_shard_count(chunks, len(devs))
    if isinstance(chunks, dict):
        return [put_stack({k: v[i] for k, v in chunks.items()}, d) for i, d in enumerate(devs)]
    return [put_stack(chunks[i], d) for i, d in enumerate(devs)]


def put_shard_feed(chunks, offsets, mesh: DeviceMesh) -> tuple[list, list[torch.Tensor]]:
    """Copy a ``shard_stacks()`` pair to the mesh's row shards: the stacks
    as :func:`put_shard_stacks` does, and shard ``k``'s int32 offsets
    ``[n_steps]`` beside its stack."""
    stacks = put_shard_stacks(chunks, mesh)
    if len(offsets) != len(stacks):
        raise ValueError(f"{len(offsets)} offset rows for {len(stacks)} shard stacks")
    return stacks, [_to(offsets[i], _dev(s)) for i, s in enumerate(stacks)]


def _dev(stack) -> torch.device:
    return (stack["label"] if isinstance(stack, dict) else stack).device


def replicated(
    vocabulary: vocab_lib.Vocabulary, mesh: DeviceMesh
) -> dict[torch.device, vocab_lib.Vocabulary]:
    """One copy of the read-only vocabulary per distinct device of the
    mesh (the vocabulary itself where it already lies on that device)."""
    return {
        d: vocab_lib.Vocabulary(table=vocabulary.table.to(d), sizes=vocabulary.sizes.to(d))
        for d in mesh.distinct_devices()
    }
