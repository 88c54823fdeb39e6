"""Placement of the row-parallel engine's feed and its read-only vocabulary.

Counterpart of the feed half of ``repro/distributed/sharding.py``
(``put_shard_feed``, ``replicated``). The feed layout is fixed by
``TabularChunkFeed.shard_stacks`` and ``BinaryChunkFeed.shard_stacks``:
leading axis = row shard, second axis = chunk step. Shard ``k``'s stack
lives on the device of row shard ``k`` for the whole epoch; the finalized
vocabulary is the only array copied to every device (it is read-only in
loop ②).

The parameter, activation and cache rules (``param_shardings``,
``cache_shardings``, ``use_mesh``, ``constrain``) come with sharded
training (ROADMAP queue 1 item 10, slice 19).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import vocab as vocab_lib
from repro_torch.launch.mesh import DeviceMesh, data_axes


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
