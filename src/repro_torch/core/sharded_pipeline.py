"""Row-parallel two-loop engine: Piper's multi-instance deployment.

Counterpart of ``repro/core/sharded_pipeline.py``. Each row shard of the
mesh is one Piper instance:

  * the dataset is row-sharded over the mesh's ``('pod', 'data')`` axes
    (``launch.mesh.make_data_mesh``); shard ``k`` holds chunks ``k,
    k + n, k + 2n, ...`` of the feed with their global row offsets;
  * **loop ①** runs per shard: each shard absorbs its own chunk stack
    into a private :class:`vocab.VocabState`, with every chunk's
    positions taken from its global offset, so the appearing order is
    that of one pass over the whole feed without any communication;
  * the per-shard states meet once, in the monoid ``vocab.merge_tree``
    on the first shard's device, the one synchronisation point of the
    epoch (:func:`all_reduce_state` is the same merge across processes);
  * **loop ②** copies the finalized vocabulary once to each device, then
    every shard transforms its own rows.

The per-shard work is an inner :class:`~repro_torch.core.pipeline.PiperPipeline`
per distinct device, built from the same config, so every shard runs the
same compiled plan on the same routes as the single-device engine: the
fused loop-① and loop-② kernels by default, the bytes-in kernels of
``use_fused_decode``, the count plane of ``track_vocab_counts``, the
per-op kernels of ``use_kernels``. The loop-① kernels update a state in
place, so every shard's state has storage of its own.

Shards run one after another on the caller's stream; on a machine with
one card every shard of a mesh is on ``cuda:0``.

Determinism contract: for the same chunk sequence
``flatten_sharded(run_scan)`` equals ``PiperPipeline.run_scan`` bit for
bit, padding rows included, at every shard count.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.distributed import sharding as sharding_lib
from repro_torch.launch.mesh import DeviceMesh, data_axes


class ShardedPiperPipeline:
    """Row-sharded two-loop preprocessing engine over a mesh's row axes.

    Args:
      config: the :class:`~repro_torch.core.pipeline.PipelineConfig` the
        single-device engine takes; its ``device`` is replaced by each
        shard's.
      mesh: a :class:`~repro_torch.launch.mesh.DeviceMesh` whose row axes
        (``'data'``, optionally ``'pod'``) carry the shards. Other axes are
        ignored: a shard runs on the device at position 0 along them.

    The feed is ``shard_stacks()`` of ``TabularChunkFeed`` or
    ``BinaryChunkFeed``: chunks ``[n_shards, n_steps, ...]`` (uint8 bytes,
    or a dict of binary arrays) and global row offsets ``[n_shards,
    n_steps]``, as host arrays or as the per-shard lists that
    ``distributed.sharding.put_shard_feed`` returns (placed once, so no
    chunk is copied during the loops).
    """

    def __init__(self, config: pipeline_lib.PipelineConfig, mesh: DeviceMesh):
        self.config = config
        self.schema = config.schema
        self.mesh = mesh
        self.row_axes = data_axes(mesh)
        if not self.row_axes:
            raise ValueError(
                f"mesh {mesh.axis_names} has no 'data'/'pod' axis to shard rows over"
            )
        self.devices = sharding_lib.row_devices(mesh)
        self.n_shards = len(self.devices)
        # One engine per distinct device: the plan is compiled once per
        # device, and every shard runs it.
        self._pipes = {
            d: pipeline_lib.PiperPipeline(dataclasses.replace(config, device=str(d)))
            for d in dict.fromkeys(self.devices)
        }
        self._pipe = self._pipes[self.devices[0]]
        self.plan = self._pipe.plan
        self.compiled = self._pipe.compiled
        labels = {"engine": "sharded", "shards": self.n_shards}
        self._loop1_labels = {**self._pipe._vocab_span_labels, **labels}
        self._loop2_labels = {**self._pipe._xform_span_labels, **labels}

    # -------------------------------------------------------------- #
    # the feed
    # -------------------------------------------------------------- #
    def _placed(self, chunks, offsets=None) -> tuple[list, list | None]:
        """The feed as per-shard lists on the shards' devices (the stacks
        alone where ``offsets`` is None); a placed feed (``put_shard_feed``'s
        lists) is returned as it is."""
        sharding_lib.check_shard_count(chunks, self.n_shards)
        if isinstance(chunks, list):
            return chunks, offsets
        if offsets is None:
            return sharding_lib.put_shard_stacks(chunks, self.mesh), None
        return sharding_lib.put_shard_feed(chunks, offsets, self.mesh)

    # -------------------------------------------------------------- #
    # loop ① — per-shard local GenVocab, then the monoid merge
    # -------------------------------------------------------------- #
    def local_state(self, stack, offsets: torch.Tensor, shard: int = 0) -> vocab_lib.VocabState:
        """Loop ① of one shard: its chunk stack ``[n_steps, ...]`` and
        global row offsets ``[n_steps]`` (copied to the device of row
        shard ``shard`` where they lie elsewhere) → the shard's private
        state, whose ``rows_seen`` is the shard's valid-row count. A
        process of a one-process-per-instance deployment calls it on its
        own stack, then :func:`all_reduce_state`.

        Each chunk's ``rows_seen`` is its global offset (a 0-d slice of the
        offsets on the device: no copy and no host read a chunk); the
        kernels write the advanced count to a new tensor, and the shard's
        count is the sum of ``advanced - offset`` in int32.
        """
        dev = self.devices[shard]
        pipe = self._pipes[dev]
        stack, offsets = sharding_lib.put_stack(stack, dev), sharding_lib.put_stack(offsets, dev)
        state = pipe.init_state()
        advanced = []
        for chunk, off in zip(pipe._unstack(stack), offsets):
            state = pipe.vocab_step(
                vocab_lib.VocabState(state.first_pos, off, state.counts), chunk
            )
            advanced.append(state.rows_seen)
        if advanced:
            n_valid = (torch.stack(advanced) - offsets).sum(dtype=torch.int32)
        else:
            n_valid = torch.zeros((), dtype=torch.int32, device=state.first_pos.device)
        return vocab_lib.VocabState(state.first_pos, n_valid, state.counts)

    def shard_states(self, chunks, offsets) -> list[vocab_lib.VocabState]:
        """Loop ① on every shard: one private state per shard."""
        stacks, offs = self._placed(chunks, offsets)
        with obs.span("loop1/shards", **self._loop1_labels):
            return [self.local_state(s, o, k) for k, (s, o) in enumerate(zip(stacks, offs))]

    def build_state_scan(self, chunks, offsets) -> vocab_lib.VocabState:
        """Loop ① up to, not including, finalization: the per-shard states,
        then the merge tree on the first shard's device. The merged state
        stays mergeable (the streaming service absorbs into it)."""
        states = self.shard_states(chunks, offsets)
        with obs.span("vocab/merge_tree", **self._loop1_labels):
            return vocab_lib.merge_tree(stack_states(states, self.devices[0]))

    def build_vocab_scan(self, chunks, offsets) -> vocab_lib.Vocabulary:
        """Loop ① end to end: local states → merge tree → finalize; equal
        to what the single-device engine builds from the same chunks."""
        return vocab_lib.finalize(self.build_state_scan(chunks, offsets))

    # -------------------------------------------------------------- #
    # loop ② — ApplyVocab + dense transforms, shard by shard
    # -------------------------------------------------------------- #
    def transform_scan(
        self, vocabulary: vocab_lib.Vocabulary, chunks
    ) -> schema_lib.ProcessedBatch:
        """Loop ② over the sharded feed with the vocabulary copied once to
        each device → ``[n_shards, n_steps, rows, ...]`` on the first
        shard's device; :func:`flatten_sharded` restores the single-device
        chunk order."""
        stacks, _ = self._placed(chunks)
        vocabs = sharding_lib.replicated(vocabulary, self.mesh)
        with obs.span("loop2/shards", **self._loop2_labels):
            per_shard = [self._pipes[d].transform_scan(vocabs[d], s)
                         for d, s in zip(self.devices, stacks)]
        first = self.devices[0]
        return schema_lib.ProcessedBatch(**{
            f.name: torch.stack([getattr(b, f.name).to(first) for b in per_shard])
            for f in dataclasses.fields(schema_lib.ProcessedBatch)
        })

    def run_scan(self, chunks, offsets) -> schema_lib.ProcessedBatch:
        """Both loops over the sharded feed (placed once); bit-identical to
        ``PiperPipeline.run_scan`` on the same chunk sequence."""
        stacks, offs = self._placed(chunks, offsets)
        vocabulary = self.build_vocab_scan(stacks, offs)
        return self.transform_scan(vocabulary, stacks)


def stack_states(states: list[vocab_lib.VocabState], device) -> vocab_lib.VocabState:
    """Per-shard states → one state with a leading shard axis on
    ``device`` (new storage: no shard's tensors are shared)."""
    return vocab_lib.VocabState(
        first_pos=torch.stack([s.first_pos.to(device) for s in states]),
        rows_seen=torch.stack([s.rows_seen.to(device) for s in states]),
        counts=(
            None if states[0].counts is None
            else torch.stack([s.counts.to(device) for s in states])
        ),
    )


def flatten_sharded(out: schema_lib.ProcessedBatch) -> schema_lib.ProcessedBatch:
    """``[n_shards, n_steps, rows, ...]`` → ``[n_shards*n_steps*rows, ...]``.

    Restores the round-robin chunk order of the feeds (chunk ``i`` lives at
    shard ``i % n_shards``, step ``i // n_shards``), so the result matches
    ``pipeline.flatten_processed`` of the single-device engine on the same
    feed, padding rows kept (filter with ``valid``).
    """

    def flat(x):
        x = x.transpose(0, 1)  # [n_steps, n_shards, rows, ...]
        return x.reshape((-1,) + tuple(x.shape[3:]))

    return schema_lib.ProcessedBatch(
        label=flat(out.label), dense=flat(out.dense), sparse=flat(out.sparse),
        valid=flat(out.valid),
    )


def all_reduce_state(state: vocab_lib.VocabState, group=None) -> vocab_lib.VocabState:
    """Merge the states of every process of a ``torch.distributed`` group:
    the per-process counterpart of :func:`vocab.merge_tree`, for a
    deployment with one process per instance.

    Three reductions: ``MIN`` on ``first_pos``, ``SUM`` on ``counts``, and
    ``rows_seen`` summed in int64 and clamped at ``NEVER`` (for counts in
    ``[0, NEVER]`` that is the saturating ``advance_rows_seen`` fold).
    Returns a new state; the caller's tensors are left as they were.
    """
    import torch.distributed as dist

    first_pos = state.first_pos.clone()
    dist.all_reduce(first_pos, op=dist.ReduceOp.MIN, group=group)
    counts = None
    if state.counts is not None:
        counts = state.counts.clone()
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    rows = state.rows_seen.to(torch.int64).reshape(1)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    rows_seen = torch.clamp(rows, max=vocab_lib.NEVER).to(torch.int32).reshape(())
    return vocab_lib.VocabState(first_pos=first_pos, rows_seen=rows_seen, counts=counts)
