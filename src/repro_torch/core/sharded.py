"""Column-parallel sharded engine: Piper's column split, on a mesh.

Counterpart of ``repro/core/sharded.py``. Piper assigns *columns* to its
parallel workers, so the stateful vocabulary needs no synchronisation:
each worker owns its columns' state outright. On a mesh:

    rows            → the ``data`` (× ``pod``) axes   (streaming chunks)
    sparse columns  → the ``model`` axis              (per-column state)

Each (row shard, model shard) position decodes its row shard's chunk (the
bytes are replicated over ``model``, as the FPGA decoder broadcasts into
per-column FIFOs), takes its contiguous block of the columns, padded with
0 up to a multiple of the model axis, and updates only its own block of
the state. The one collective of the epoch is a min over the row shards
at finalize; loop ② reads each position's own block of the table.

The state is one ``[cols_local, vocab_range]`` int32 block per position,
on that position's device, each with storage of its own (the GenVocab
kernel updates it in place). :meth:`ShardedPiper.stacked_state` gives the
reference's stacked layout ``[n_row_shards, cols_pad, vocab_range]``.

On the card each step is, per position, one decode launch, then in loop ①
one launch of the per-op GenVocab kernel (``kernels/vocab``) with
``rows_seen`` set to the chunk's global offset, and in loop ② one
ApplyVocab and one dense-transform launch (``kernels/vocab``,
``kernels/dense_xform``). On the CPU each takes its plain version.

The reference runs the Criteo chain on UTF-8 whatever the config says; the
port refuses what it would ignore: a plan other than the default, the
count plane and a binary feed raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import schema as schema_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.distributed.sharding import put_stack
from repro_torch.kernels.vocab import ops as vocab_ops
from repro_torch.launch.mesh import DeviceMesh, data_axes

MODEL_AXIS = "model"


def _model_size(mesh: DeviceMesh) -> int:
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(
            f"mesh {mesh.axis_names} has no {MODEL_AXIS!r} axis to split the columns over")
    return mesh.shape[MODEL_AXIS]


def padded_cols(n_sparse: int, mesh: DeviceMesh) -> int:
    """The sparse columns padded up to a multiple of the model axis."""
    m = _model_size(mesh)
    return (n_sparse + m - 1) // m * m


class ShardedPiper:
    """Mesh-distributed two-loop engine: rows over ``('pod', 'data')``,
    sparse columns over ``model``; ``state[r][m]`` is the block of row
    shard ``r`` and model shard ``m``."""

    def __init__(self, config: pipeline_lib.PipelineConfig, mesh: DeviceMesh):
        if config.plan is not None and config.plan != plan_lib.criteo_default(config.schema):
            raise ValueError("ShardedPiper runs the default Criteo chain only; "
                             "pass plan=None (ShardedPiperPipeline runs any plan)")
        if config.track_vocab_counts:
            raise ValueError("ShardedPiper keeps no count plane; "
                             "use track_vocab_counts=False (or ShardedPiperPipeline)")
        if config.input_format != "utf8":
            raise ValueError(f"ShardedPiper decodes UTF-8 chunks; input_format="
                             f"{config.input_format!r} is not supported (ShardedPiperPipeline "
                             "takes binary feeds)")
        self.config = config
        self.schema = config.schema
        self.mesh = mesh
        self.model_size = _model_size(mesh)
        self.row_axes = data_axes(mesh)
        self.n_row_shards = math.prod(mesh.shape[a] for a in self.row_axes)
        self.cols_pad = padded_cols(self.schema.n_sparse, mesh)
        self.cols_local = self.cols_pad // self.model_size
        by_model = [mesh.along(self.row_axes, model=m) for m in range(self.model_size)]
        # devices[r][m]: the device of row shard r, model shard m
        self.devices = [[by_model[m][r] for m in range(self.model_size)]
                        for r in range(self.n_row_shards)]
        self._pipes = {
            d: pipeline_lib.PiperPipeline(dataclasses.replace(config, device=str(d)))
            for d in mesh.distinct_devices()
        }

    def _positions(self):
        for r in range(self.n_row_shards):
            for m in range(self.model_size):
                yield r, m, self.devices[r][m]

    # -------------------------------------------------------------- #
    # state
    # -------------------------------------------------------------- #
    def init_state(self) -> list[list[torch.Tensor]]:
        """A fresh ``NEVER`` block per position, each its own allocation."""
        return [[torch.full((self.cols_local, self.schema.vocab_range), vocab_lib.NEVER,
                            dtype=torch.int32, device=d) for d in row] for row in self.devices]

    def stacked_state(self, state) -> torch.Tensor:
        """The reference's layout: ``[n_row_shards, cols_pad, vocab_range]``
        on the first position's device."""
        d0 = self.devices[0][0]
        return torch.stack([torch.cat([b.to(d0) for b in row]) for row in state])

    # -------------------------------------------------------------- #
    # shared local stages
    # -------------------------------------------------------------- #
    def _placed(self, chunks, offsets) -> dict:
        """One step's (or a scan's) chunks and offsets on every distinct
        device of the mesh: the bytes replicated over ``model``."""
        return {d: (put_stack(chunks, d), None if offsets is None else put_stack(offsets, d))
                for d in self._pipes}

    def _local(self, chunk: torch.Tensor, dev: torch.device, m: int):
        """Decode a row chunk; its modded sparse block of model shard ``m``
        (zero-padded columns, contiguous) and the decoded batch."""
        batch = self._pipes[dev].decode_chunk(chunk)
        modded = ops.positive_modulus(batch.sparse, self.schema.vocab_range)
        padded = F.pad(modded, (0, self.cols_pad - self.schema.n_sparse))
        local = padded[:, m * self.cols_local:(m + 1) * self.cols_local].contiguous()
        return local, batch

    # -------------------------------------------------------------- #
    # loop ① — sharded GenVocab
    # -------------------------------------------------------------- #
    def _vocab_step(self, state, placed: dict, step: int | None):
        new = [list(row) for row in state]
        for r, m, dev in self._positions():
            chunks, offsets = placed[dev]
            if step is not None:
                chunks, offsets = chunks[step], offsets[step]
            local, batch = self._local(chunks[r], dev, m)
            st = vocab_ops.genvocab_update(
                vocab_lib.VocabState(state[r][m], offsets[r]), local, batch.valid)
            new[r][m] = st.first_pos
        return new

    def vocab_step(self, state, chunks, offsets):
        """One streaming step: ``chunks`` uint8 ``[n_row_shards,
        chunk_bytes]``, one chunk per row shard, and ``offsets`` int32
        ``[n_row_shards]``, the global row offset of each (the appearing
        order across shards). On the card the blocks are updated in place:
        thread the returned state through."""
        return self._vocab_step(state, self._placed(chunks, offsets), None)

    def finalize(self, state) -> list[list[vocab_lib.Vocabulary]]:
        """The one collective: the min over row shards of each model
        shard's blocks, on that model shard's first device, then the
        ranking of each column. Returns the table's block of model shard
        ``m`` at ``[r][m]``, on that position's device."""
        out = [[None] * self.model_size for _ in range(self.n_row_shards)]
        for m in range(self.model_size):
            home = self.devices[0][m]
            first_pos = torch.stack([state[r][m].to(home) for r in range(self.n_row_shards)])
            voc = vocab_lib.finalize(vocab_lib.VocabState(
                first_pos=first_pos.amin(dim=0),
                rows_seen=torch.zeros((), dtype=torch.int32, device=home)))
            for r in range(self.n_row_shards):
                d = self.devices[r][m]
                out[r][m] = vocab_lib.Vocabulary(table=voc.table.to(d), sizes=voc.sizes.to(d))
        return out

    def stacked_vocabulary(self, vocabulary) -> vocab_lib.Vocabulary:
        """The finalized blocks as one ``[cols_pad, vocab_range]`` table on
        the first position's device."""
        d0 = self.devices[0][0]
        return vocab_lib.Vocabulary(
            table=torch.cat([v.table.to(d0) for v in vocabulary[0]]),
            sizes=torch.cat([v.sizes.to(d0) for v in vocabulary[0]]))

    # -------------------------------------------------------------- #
    # loop ② — sharded ApplyVocab + dense transforms
    # -------------------------------------------------------------- #
    def _transform_step(self, vocabulary, placed: dict, step: int | None):
        d0 = self.devices[0][0]
        label, dense, ids, valid = [], [], [], []
        for r in range(self.n_row_shards):
            blocks = []
            for m in range(self.model_size):
                dev = self.devices[r][m]
                chunks = placed[dev][0] if step is None else placed[dev][0][step]
                local, batch = self._local(chunks[r], dev, m)
                blocks.append(vocab_ops.apply_vocab(vocabulary[r][m].table, local).to(d0))
                dfx = ops.dense_transform(batch.dense, use_kernel=True)
                if m == 0:
                    label.append(batch.label.to(d0))
                    dense.append(dfx.to(d0))
                    valid.append(batch.valid.to(d0))
            ids.append(torch.cat(blocks, dim=1))
        # Columns stay padded to a multiple of the model axis: the padding
        # columns hold ordinal 0 everywhere.
        return schema_lib.ProcessedBatch(
            label=torch.stack(label), dense=torch.stack(dense), sparse=torch.stack(ids),
            valid=torch.stack(valid))

    def transform_step(self, vocabulary, chunks) -> schema_lib.ProcessedBatch:
        """Transform one chunk per row shard → ``[n_row_shards, rows, ...]``
        on the first position's device, ids ``[..., cols_pad]``."""
        return self._transform_step(vocabulary, self._placed(chunks, None), None)

    # -------------------------------------------------------------- #
    # end to end
    # -------------------------------------------------------------- #
    def run_scan(self, stacked_chunks, offsets) -> schema_lib.ProcessedBatch:
        """Both loops over ``stacked_chunks`` uint8 ``[n_steps,
        n_row_shards, chunk_bytes]`` and ``offsets`` int32 ``[n_steps,
        n_row_shards]`` (``TabularChunkFeed.stacked`` / ``.offsets``),
        copied once to each distinct device → ``[n_steps, n_row_shards,
        rows, ...]``."""
        placed = self._placed(stacked_chunks, offsets)
        n_steps = len(offsets)
        state = self.init_state()
        for i in range(n_steps):
            state = self._vocab_step(state, placed, i)
        vocabulary = self.finalize(state)
        outs = [self._transform_step(vocabulary, placed, i) for i in range(n_steps)]
        return schema_lib.ProcessedBatch(**{
            f.name: torch.stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(schema_lib.ProcessedBatch)
        })
