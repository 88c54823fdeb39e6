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
move the same way (:func:`lm_params_from_numpy`, every layer kind's
leaves: attention, MoE, Mamba, mLSTM, sLSTM, and an ``EncDec``'s
encoder), and so do an LM trainer's state
(:func:`lm_train_state_to_numpy`), which is the tree its checkpoints
hold, and an LM's decode state (:func:`lm_decode_state_to_numpy`: KV
caches, ring slots, cross layers' context caches and recurrent states).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import vocab as vocab_lib
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import lm as lm_lib
from repro_torch.train.tree import leaves, tree_map


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


def _lm_skeleton(cfg) -> dict:
    """The port's parameters of ``cfg`` on the ``meta`` device (no memory):
    ``EncDec``'s for the audio family, else ``LM``'s."""
    model = lm_lib.EncDec if cfg.family == "audio" else lm_lib.LM
    return model(cfg, device="meta").init()


def lm_params_from_numpy(tree, cfg, *, device="cuda"):
    """The JAX package's ``LM.init`` tree for ``cfg`` (float32 arrays:
    ``embed``, the ``blocks`` tuple of per-spec dicts stacked on a leading
    ``n_superblocks`` axis, ``final_norm``, and ``lm_head`` when untied;
    for the audio family ``EncDec.init``'s, which adds ``encoder``:
    ``blocks`` stacked on ``n_encoder_superblocks``, ``pos_embed``,
    ``final_norm``) → the port's parameters on ``device``, superblock by
    superblock. Every leaf's shape is checked against the port's own
    parameters."""
    dev = lm_lib._resolve_device(device)

    def load(want, x, name):
        t = _float32(x, name)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(want.shape)}")
        return t.to(dev)

    def unstack(skeleton, stacked, specs, name):
        if len(stacked) != len(specs):
            raise ValueError(f"{name}: {len(stacked)} stacked specs, expected {len(specs)}")
        return [
            [tree_map(lambda w, x: load(w, np.asarray(x)[i], f"{name}[{j}][{i}]"), p, stacked[j])
             for j, p in enumerate(sb)]
            for i, sb in enumerate(skeleton)
        ]

    def tree_of(skeleton, node, specs, prefix=""):
        out = {}
        for key, sub in skeleton.items():
            if key == "blocks":
                out[key] = unstack(sub, node[key], specs, prefix + key)
            elif key == "encoder":
                out[key] = tree_of(sub, node[key], cfg.encoder_superblock, "encoder.")
            else:
                out[key] = tree_map(lambda w, x: load(w, x, prefix + key), sub, node[key])
        return out

    return tree_of(_lm_skeleton(cfg), tree, cfg.superblock)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array of its own (a CPU tensor is copied too)."""
    return t.detach().to("cpu", copy=True).numpy()


def _stacked(params: dict, stack, leaf) -> dict:
    """``params`` in the reference's layout: every ``blocks`` list (the
    decoder's, the encoder's) a tuple of per-spec trees with each leaf
    ``stack(*layers)``, every other leaf ``leaf(t)``."""
    out = {}
    for key, sub in params.items():
        if key == "blocks":
            out[key] = tuple(tree_map(stack, *specs) for specs in zip(*sub))
        elif key == "encoder":
            out[key] = _stacked(sub, stack, leaf)
        else:
            out[key] = tree_map(leaf, sub)
    return out


def lm_params_to_numpy(params) -> dict:
    """The port's ``LM`` or ``EncDec`` parameters → the JAX package's tree:
    float32 numpy arrays, each spec's layers stacked on a leading
    ``n_superblocks`` (``n_encoder_superblocks``) axis. Every array is a
    host copy of its own, each layer copied once, straight into its slot."""
    def stack(*layers):
        arr = np.empty((len(layers),) + tuple(layers[0].shape), np.float32)
        for i, t in enumerate(layers):
            torch.from_numpy(arr[i]).copy_(t.detach())
        return arr

    return _stacked(params, stack, _host_copy)


def lm_adamw_state_from_numpy(state, cfg, *, device="cuda") -> dict:
    """The JAX package's AdamW state of an ``LM`` (``{"m", "v", "step"}``,
    ``m`` and ``v`` in the stacked ``LM.init`` tree) → the port's, on
    ``device``, ``m`` and ``v`` superblock by superblock."""
    dev = lm_lib._resolve_device(device)
    return {"m": lm_params_from_numpy(state["m"], cfg, device=dev),
            "v": lm_params_from_numpy(state["v"], cfg, device=dev),
            "step": _int32(state["step"], "step", 0, dev)}


def lm_adamw_state_to_numpy(state: dict) -> dict:
    """The port's AdamW state of an ``LM`` → the JAX package's tree (``m``
    and ``v`` stacked as :func:`lm_params_to_numpy` stacks them)."""
    return {"m": lm_params_to_numpy(state["m"]), "v": lm_params_to_numpy(state["v"]),
            "step": _host_copy(state["step"])}


def lm_train_state_to_numpy(params, opt_state: dict) -> dict:
    """``{"params", "opt"}`` of an LM trainer in the JAX package's layout
    (stacked), every leaf a host copy of its own: the tree that
    ``train/trainer.py`` checkpoints, so that either package's ``Trainer``
    resumes the other's checkpoints."""
    return {"params": lm_params_to_numpy(params), "opt": lm_adamw_state_to_numpy(opt_state)}


def lm_train_state_from_numpy(tree, cfg, *, device="cuda") -> tuple:
    """The tree of :func:`lm_train_state_to_numpy` (or the JAX trainer's
    checkpoint, restored as numpy or CPU tensors) → ``(params, opt_state)``
    in the port's layout on ``device``."""
    return (lm_params_from_numpy(tree["params"], cfg, device=device),
            lm_adamw_state_from_numpy(tree["opt"], cfg, device=device))


def lm_train_state_like(cfg) -> dict:
    """The shapes of :func:`lm_train_state_to_numpy`'s tree for ``cfg``, as
    tensors on the ``meta`` device (no memory): the ``like`` tree of
    ``train/checkpoint.py::restore``."""
    def stack(*layers):
        t = layers[0]
        return torch.empty((len(layers),) + tuple(t.shape), dtype=t.dtype, device="meta")

    params = _stacked(_lm_skeleton(cfg), stack, lambda t: t)
    step = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": params, "opt": {"m": params, "v": params, "step": step}}


def lm_decode_state_to_numpy(state) -> tuple:
    """The port's ``LM`` decode state (``[superblock][spec]`` dicts) → the
    JAX package's: a tuple of per-spec dicts, each leaf stacked on a leading
    ``n_superblocks`` axis (KV caches, ring slots, a cross layer's
    ``ctx_kv``, recurrent states). Floating leaves become float32 arrays (a
    bf16 cache exactly), ``slot_pos`` stays int32."""
    def stack(*layers):
        return np.stack([_host_copy(t if t.dtype == torch.int32 else t.to(torch.float32))
                         for t in layers])

    return tuple(tree_map(stack, *specs) for specs in zip(*state))


def lm_decode_state_from_numpy(tree, *, dtype=torch.bfloat16, device="cuda") -> list:
    """The JAX package's decode state of an ``LM`` (a tuple of per-spec
    dicts stacked on ``n_superblocks``, as ``init_decode_state`` makes it)
    → the port's ``[superblock][spec]`` dicts on ``device``: the KV and
    context caches (``k``, ``v`` of ``kv`` and ``ctx_kv``) in ``dtype``,
    ``slot_pos`` int32, the recurrent states float32."""
    dev = lm_lib._resolve_device(device)

    def load(node, i, key=""):
        if isinstance(node, dict):
            return {k: load(v, i, k) for k, v in node.items()}
        arr = np.asarray(node)[i]
        if arr.dtype == np.int32:
            return torch.from_numpy(np.array(arr, copy=True)).to(dev)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True)).to(dev)
        return t.to(dtype) if key in ("k", "v") else t

    n = int(np.shape(leaves(tree)[0])[0])
    return [[load(spec_tree, i) for spec_tree in tree] for i in range(n)]
