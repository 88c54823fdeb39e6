"""Fault-tolerant training loop for the language model.

Counterpart of ``repro/train/trainer.py``, with the same behaviours:

  * **checkpoint/restart** — asynchronous atomic checkpoints every
    ``ckpt_every`` steps (parameters, AdamW state, and ``extra_state``
    such as Piper's ``VocabState``); on start the trainer resumes from the
    newest complete checkpoint.
  * **deterministic data skip-ahead** — the batch of step *i* is
    ``batch_fn(i)``, a pure function of the step, so a resumed job takes
    exactly the batches it would have taken, with no replay buffer.
  * **preemption** — SIGTERM/SIGINT (or :meth:`Trainer.request_preemption`)
    set a flag; the loop finishes the step in flight, saves, and leaves.
  * **stragglers** — each step's host time is held against an EMA (step 0
    kept out of it); a step slower than ``straggler_factor`` times the EMA
    is counted and passed to ``straggler_callback``.
  * **loss-spike guard** — a non-finite loss rolls back to the last
    checkpoint (counted in ``rollbacks``).

Checkpoints are written in the JAX package's stacked layout
(``interop.lm_train_state_to_numpy``), so a checkpoint of either package's
``Trainer`` resumes in the other's. The step updates the parameters in
place (``train/steps.py``); the loss of step *i* is read on the host only
after step *i+1* is enqueued, and always before a save. While the
process tracer is on (:mod:`repro_torch.obs`), each save's snapshot is the
span ``train/checkpoint`` and the wait for its write at the end of
:meth:`Trainer.run` ``train/checkpoint_wait``.

``Trainer(mesh=, shardings=(p_sh, o_sh, b_sh))`` trains over a
:class:`~repro_torch.launch.mesh.DeviceMesh` with the reference's
contract: the step's values are those of the unsharded step over the
global batch. Every position of the mesh must lie on the model's device
(on one card, all on ``cuda:0``), so the blocks of ``p_sh`` / ``o_sh``
are views of the whole parameters and AdamW moments (``run()`` returns
them under ``placement``): AdamW over the blocks is the elementwise update
of the whole tensors, with the same global norm, and the step is
:func:`steps.make_train_step`'s over the global batch. As the
reference's, the trainer does not enter ``sharding.use_mesh``; a caller
that wants the expert-parallel MoE path (each data shard routed on its
own) wraps :meth:`Trainer.run` in it.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import interop, obs
from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib
from repro_torch.train.tree import tree_map

Params = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep_checkpoints: int = 3
    straggler_factor: float = 2.5
    microbatches: int = 1
    handle_signals: bool = True


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index (a CUDA device named without one is the
    current one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Trainer:
    def __init__(
        self,
        model,
        opt_cfg: opt_lib.AdamWConfig,
        cfg: TrainerConfig,
        batch_fn: Callable[[int], dict],
        *,
        mesh: DeviceMesh | None = None,
        shardings: tuple | None = None,  # (params_sh, opt_sh, batch_sh)
        extra_state: Params | None = None,  # e.g. Piper's VocabState
        straggler_callback: Callable[[int, float], None] | None = None,
    ):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise ValueError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
        if shardings is not None and mesh is None:
            raise ValueError("shardings without a mesh")
        self.shardings = None
        if shardings is not None:
            if len(shardings) != 3:
                raise ValueError("shardings must be (params_sh, opt_sh, batch_sh)")
            devices = mesh.distinct_devices()
            if [_indexed(d) for d in devices] != [_indexed(model.device)]:
                raise ValueError(
                    f"the mesh's positions lie on {devices}; the sharded trainer holds every "
                    f"block on the model's device {model.device}")
            self.shardings = tuple(shardings)
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.extra_state = extra_state
        self.straggler_callback = straggler_callback
        self._preempted = False
        self._ckpt = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_checkpoints)
        self.train_step = steps_lib.make_train_step(model, opt_cfg, cfg.microbatches)

    # ------------------------------------------------------------ #
    def _install_signal_handlers(self):
        if not self.cfg.handle_signals:
            return

        def _handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _handler)
            except ValueError:
                pass  # not on the main thread (tests)

    def request_preemption(self):
        """Programmatic preemption (tests, external watchdogs)."""
        self._preempted = True

    # ------------------------------------------------------------ #
    def _save(self, step: int, params, opt_state):
        with obs.span("train/checkpoint", cat="train", step=step):
            tree = interop.lm_train_state_to_numpy(params, opt_state)
            if self.extra_state is not None:
                tree["extra"] = tree_map(ckpt_lib._snapshot, self.extra_state)
            self._ckpt.save_async(step, tree, copied=True)

    def _wait_for_checkpoint(self) -> None:
        with obs.span("train/checkpoint_wait", cat="train"):
            self._ckpt.wait()

    def _restore(self, step: int):
        """``(params, opt_state)`` of checkpoint ``step`` on the model's
        device (``extra`` is written, not read back, as in the reference)."""
        like = interop.lm_train_state_like(self.model.cfg)
        tree = ckpt_lib.restore(self.cfg.ckpt_dir, step, like, device="cpu")
        return interop.lm_train_state_from_numpy(tree, self.model.cfg, device=self.model.device)

    def _place(self, params, opt_state) -> dict | None:
        """The blocks of ``params`` under ``p_sh`` and of ``opt_state``
        under ``o_sh`` (views of the whole tensors), as trees of
        ``sharding.ShardedTensor``; None without shardings."""
        if self.shardings is None:
            return None
        p_sh, o_sh, _ = self.shardings
        of = shard_lib.ShardedTensor.of
        return {"params": tree_map(lambda p, sh: of(p.detach(), sh), params, p_sh),
                "opt": tree_map(lambda x, sh: of(x, sh), opt_state, o_sh)}

    def _batch(self, step: int) -> dict:
        dev = self.model.device
        return {k: torch.as_tensor(v).to(dev) for k, v in self.batch_fn(step).items()}

    # ------------------------------------------------------------ #
    def run(self, key: int | torch.Generator = 0) -> dict:
        """Train to ``total_steps`` from the newest checkpoint, or from
        ``model.init`` drawn from ``key`` (a seed, or a generator on the
        model's device)."""
        self._install_signal_handlers()
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is not None:
            params, opt_state = self._restore(latest)
            start = latest
        else:
            gen = key if isinstance(key, torch.Generator) else \
                torch.Generator(self.model.device).manual_seed(int(key))
            params = self.model.init(gen)
            opt_state = opt_lib.adamw_init(params)
            start = 0
        placement = self._place(params, opt_state)

        losses: list[float] = []
        step_times: list[float] = []
        ema = None
        stragglers = 0
        rollbacks = 0
        input_wait_s = 0.0

        # Lagged loss read: float(loss) waits for the device, so step i's
        # loss is read after step i+1 is enqueued. `pending` holds the one
        # unread (step, metrics) pair; it is drained before every save (and
        # at loop exit), so no unchecked, possibly non-finite, step is ever
        # persisted.
        pending: tuple | None = None

        def resolve() -> int | None:
            """Read the lagged step's loss. Returns its step index when the
            loss was non-finite (the caller rolls back), else None."""
            nonlocal pending
            if pending is None:
                return None
            (p_step, p_metrics), pending = pending, None
            loss = float(p_metrics["loss"])
            if not np.isfinite(loss):
                return p_step
            losses.append(loss)
            return None

        def rollback(bad_step: int) -> None:
            """Restore the last checkpoint (the in-flight step's parameters
            go with it)."""
            nonlocal params, opt_state, placement, step, rollbacks, pending
            pending = None
            rollbacks += 1
            last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
            if last is None:
                raise FloatingPointError(f"non-finite loss at step {bad_step}")
            self._ckpt.wait()
            params, opt_state = self._restore(last)
            placement = self._place(params, opt_state)
            step = last

        step = start
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            batch = self._batch(step)  # deterministic in step → skip-ahead
            input_wait_s += time.perf_counter() - t0
            metrics = self.train_step(params, opt_state, batch)
            bad = resolve()  # the previous step's loss, while this one runs
            pending = (step, metrics)
            dt = time.perf_counter() - t0
            step_times.append(dt)
            # step 0 includes the first call's warm-up: keep it out of the EMA
            if len(step_times) == 2:
                ema = dt
            elif ema is not None:
                ema = 0.9 * ema + 0.1 * dt
            if ema is not None and dt > self.cfg.straggler_factor * ema and len(step_times) > 3:
                stragglers += 1
                if self.straggler_callback:
                    self.straggler_callback(step, dt)

            if bad is not None:
                rollback(bad)
                continue

            step += 1
            if (
                step % self.cfg.ckpt_every == 0
                or step == self.cfg.total_steps
                or self._preempted
            ):
                bad = resolve()  # drain the lag: never persist unchecked
                if bad is not None:
                    rollback(bad)
                    continue
                self._save(step, params, opt_state)
            if self._preempted:
                if pending is not None:
                    # the flag landed after the boundary check read false:
                    # this step is still unsaved
                    bad = resolve()
                    if bad is not None:
                        rollback(bad)
                        continue
                    self._save(step, params, opt_state)
                self._wait_for_checkpoint()
                break

        bad = resolve()  # the loop leaves with the lag drained, except by break
        if bad is not None:
            raise FloatingPointError(f"non-finite loss at step {bad}")
        self._wait_for_checkpoint()
        return {
            "final_step": step,
            "losses": losses,
            "step_times": step_times,
            "stragglers": stragglers,
            "rollbacks": rollbacks,
            "preempted": self._preempted,
            "input_wait_s": input_wait_s,
            "params": params,
            "opt_state": opt_state,
            "placement": placement,
        }
