"""Carry learned state, plans and weights between packages.

What loop ① learns is the :class:`~repro_torch.core.vocab.VocabState`
(first positions, row count and the optional count plane) and what loop ②
serves is the finalized :class:`~repro_torch.core.vocab.Vocabulary`.
These functions move both to and from numpy, so a state that the JAX
package's loop ① built continues in the port's, and the reverse.
:func:`plan_from_reference` turns the JAX package's preprocessing plan
into the port's, so both compile one plan. The DLRM's parameters and its
AdamW state move as the JAX package's trees of numpy arrays, so both
packages train from the same weights; the language model's parameters
move the same way (:func:`lm_params_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import lm as lm_lib
from repro_torch.train.tree import tree_map


def _int32(x, name: str, ndim: int, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != np.int32:
        raise TypeError(f"{name}: expected int32, got {arr.dtype}")
    if arr.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {arr.shape}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def vocab_state_from_numpy(
    first_pos, rows_seen, counts=None, *, device
) -> vocab_lib.VocabState:
    """int32 ``first_pos [n_columns, vocab_range]``, int32 scalar
    ``rows_seen`` and optional int32 ``counts`` → a state on ``device``."""
    fp = _int32(first_pos, "first_pos", 2, device)
    cnt = None
    if counts is not None:
        cnt = _int32(counts, "counts", 2, device)
        if cnt.shape != fp.shape:
            raise ValueError(f"counts {tuple(cnt.shape)} vs first_pos {tuple(fp.shape)}")
    return vocab_lib.VocabState(
        first_pos=fp, rows_seen=_int32(rows_seen, "rows_seen", 0, device), counts=cnt
    )


def vocab_state_to_numpy(state: vocab_lib.VocabState):
    """→ ``(first_pos, rows_seen, counts | None)`` as int32 numpy arrays."""
    counts = None if state.counts is None else state.counts.cpu().numpy()
    return state.first_pos.cpu().numpy(), state.rows_seen.cpu().numpy(), counts


def vocabulary_from_numpy(table, sizes, *, device) -> vocab_lib.Vocabulary:
    """int32 ``table [n_columns, vocab_range]`` and ``sizes [n_columns]``
    → a vocabulary on ``device``."""
    return vocab_lib.Vocabulary(
        table=_int32(table, "table", 2, device), sizes=_int32(sizes, "sizes", 1, device)
    )


def vocabulary_to_numpy(vocab: vocab_lib.Vocabulary):
    """→ ``(table, sizes)`` as int32 numpy arrays."""
    return vocab.table.cpu().numpy(), vocab.sizes.cpu().numpy()


def plan_from_reference(plan) -> plan_lib.PreprocPlan:
    """A ``PreprocPlan`` of the JAX package → the port's, field by field.

    Reads only attributes (``columns``; each column's ``kind``, ``source``,
    ``ops`` and ``name``; each op's ``name`` and ``params``), so it needs
    nothing of the JAX package and takes any object of that shape."""
    return plan_lib.PreprocPlan(
        columns=tuple(
            plan_lib.ColumnSpec(
                kind=c.kind,
                source=tuple(c.source) if isinstance(c.source, tuple) else c.source,
                ops=tuple(plan_lib.OpSpec(name=o.name, params=tuple(o.params)) for o in c.ops),
                name=c.name,
            )
            for c in plan.columns
        )
    )


def _float32(x, name: str) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != np.float32:
        raise TypeError(f"{name}: expected float32, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


def dlrm_params_from_numpy(tree, *, device="cuda"):
    """The JAX package's DLRM parameter tree (``{"tables", "bottom": [{"w",
    "b"}, ...], "top": [...]}`` of float32 arrays) → a port ``DLRM`` on
    ``device`` with those weights; its config is read off the shapes."""
    n_sparse, vocab_range, embed_dim = np.shape(tree["tables"])
    cfg = dlrm_lib.DLRMConfig(
        n_dense=int(np.shape(tree["bottom"][0]["w"])[0]),
        n_sparse=int(n_sparse),
        vocab_range=int(vocab_range),
        embed_dim=int(embed_dim),
        bottom_mlp=tuple(int(np.shape(l["w"])[1]) for l in tree["bottom"]),
        top_mlp=tuple(int(np.shape(l["w"])[1]) for l in tree["top"]),
    )
    model = dlrm_lib.DLRM(cfg, device=device)

    def load(p, x):
        t = _float32(x, "DLRM parameter")
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"DLRM parameter of shape {tuple(t.shape)}, expected "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(t)

    tree_map(load, model.params_tree(), tree)
    return model


def dlrm_params_to_numpy(model) -> dict:
    """A port ``DLRM`` → its parameters as the JAX package's tree of float32
    numpy arrays."""
    return tree_map(lambda p: p.detach().cpu().numpy(), model.params_tree())


def adamw_state_from_numpy(state, *, device="cuda") -> dict:
    """The JAX package's AdamW state (``{"m", "v", "step"}``, ``m`` and
    ``v`` mirroring the parameter tree) → the port's, on ``device``."""
    def moment(x):
        return _float32(x, "AdamW moment").to(device)

    return {"m": tree_map(moment, state["m"]), "v": tree_map(moment, state["v"]),
            "step": _int32(state["step"], "step", 0, device)}


def adamw_state_to_numpy(state: dict) -> dict:
    """The port's AdamW state → numpy arrays in the JAX package's tree."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def lm_params_from_numpy(tree, cfg, *, device="cuda"):
    """The JAX package's ``LM.init`` tree for ``cfg`` (float32 arrays:
    ``embed``, the ``blocks`` tuple of per-spec dicts stacked on a leading
    ``n_superblocks`` axis, ``final_norm``, and ``lm_head`` when untied)
    → the port's ``LM`` parameters on ``device``, superblock by superblock.
    Every leaf's shape is checked against the port's own parameters."""
    dev = lm_lib._resolve_device(device)
    skeleton = lm_lib.LM(cfg, device="meta").init()
    if len(tree["blocks"]) != len(cfg.superblock):
        raise ValueError(f"{len(tree['blocks'])} stacked specs, expected {len(cfg.superblock)}")

    def load(want, x, name):
        t = _float32(x, name)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(want.shape)}")
        return t.to(dev)

    out = {}
    for key in skeleton:
        if key == "blocks":
            continue
        out[key] = tree_map(lambda w, x: load(w, x, key), skeleton[key], tree[key])
    out["blocks"] = [
        [tree_map(lambda w, x: load(w, np.asarray(x)[i], f"blocks[{j}][{i}]"), p, tree["blocks"][j])
         for j, p in enumerate(sb)]
        for i, sb in enumerate(skeleton["blocks"])
    ]
    return out


def lm_params_to_numpy(params) -> dict:
    """The port's ``LM`` parameters → the JAX package's tree: float32 numpy
    arrays, each spec's layers stacked on a leading ``n_superblocks`` axis."""
    out = {k: tree_map(lambda t: t.detach().cpu().numpy(), v)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = tuple(
        tree_map(lambda *ts: np.stack([t.detach().cpu().numpy() for t in ts]), *specs)
        for specs in zip(*params["blocks"])
    )
    return out
