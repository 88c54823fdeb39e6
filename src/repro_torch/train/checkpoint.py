"""Checkpointing: atomic, manifest-addressed, in the reference's format.

Counterpart of ``repro/train/checkpoint.py``, writing the same layout, so
either package restores the other's checkpoints::

    <root>/step_000100/
        MANIFEST.json    {"step": 100, "leaves": {...}, "complete": true}
        arr_00000.npy ... one file per tree leaf, in sorted key order

A leaf's key is its path in the tree joined by "/": dict keys, list
indices and dataclass field names, e.g. ``params/tables``,
``params/bottom/0/w``, ``opt/m/tables``, ``opt/step`` and
``extra/vocab/first_pos`` for Piper's ``VocabState`` under ``extra``.

  * **atomic**: a save is written to ``step_N.tmp`` and renamed; a
    restore lists only steps whose manifest says ``complete``.
  * **async**: :class:`AsyncCheckpointer` copies the tree to host memory
    on the caller's thread, then writes it on a thread of its own.
  * ``restore`` rebuilds the port's tensors on the device it is given.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, tree_map

_SEP = "/"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A host copy that later in-place updates of ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return leaf.detach().cpu().numpy()
    return np.array(_numpy(leaf), copy=True)


def save(root: str, step: int, tree) -> str:
    """Synchronous atomic save. Returns the final directory."""
    flat = {_SEP.join(path): leaf for path, leaf in leaves_with_paths(tree)}
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = {}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr = _numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        leaves[key] = {"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    manifest = {"step": step, "leaves": leaves, "complete": True}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread checkpointing; keeps the newest
    ``keep`` complete steps. A failed write raises from :meth:`wait` (or
    the next :meth:`save_async`)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree) -> None:
        self.wait()  # one outstanding save at a time
        host_tree = tree_map(_snapshot, tree)  # synchronous snapshot

        def _write():
            try:
                save(self.root, step, host_tree)
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = list_steps(self.root)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)


def list_steps(root: str) -> list[int]:
    """The steps under ``root`` whose manifest says ``complete``, ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        try:
            with open(os.path.join(root, name, "MANIFEST.json")) as f:
                if json.load(f).get("complete"):
                    out.append(int(m.group(1)))
        except (OSError, json.JSONDecodeError):
            continue  # incomplete or corrupt: a crash mid-save
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore(root: str, step: int, like, *, device="cuda"):
    """The checkpoint of ``step`` in the structure of ``like`` (a tree whose
    leaves have ``.shape``: tensors, arrays), every leaf a tensor on
    ``device``. Raises ``KeyError`` for a leaf the checkpoint lacks and
    ``ValueError`` for one of another shape."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    loaded = []
    for path, leaf in leaves_with_paths(like):
        key = _SEP.join(path)
        entry = manifest["leaves"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(d, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape}, expected "
                             f"{tuple(leaf.shape)}")
        loaded.append(torch.from_numpy(arr).to(device))
    it = iter(loaded)
    return tree_map(lambda _: next(it), like)
