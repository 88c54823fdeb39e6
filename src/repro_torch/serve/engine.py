"""Batched serving engine: prefill-then-decode with continuous batching.

Counterpart of ``repro/serve/engine.py``, the same logic on the model's
device: a slot-based engine holding a fixed decode batch. Requests occupy
slots; finished or empty slots are refilled from a queue each step.

Prefill is "chunked into decode": a request's prompt tokens are fed
through ``decode_step`` at positions 0..n-1 into its slot's cache. Every
slot shares one position, the largest over the slots, as in the reference
(per-slot positions are a feature neither package has); requests admitted
in one wave stay in step.

A slot given to a new request starts its recurrent states (Mamba, mLSTM,
sLSTM) anew (``lm.reset_decode_rows``); its KV caches need no reset, since
the position mask hides what the slot's last request wrote. The reference
engine keeps those states across requests, so a request's tokens there
depend on the slot's last request (a fault of the reference, ROADMAP
queue 3), which the port does not copy.

A vision LM's cross layers attend to the decode state's ``ctx_kv``
caches, which stay zero: the reference's engine never calls
``fill_context_caches`` (ROADMAP queue 3), and neither does this one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import lm as lm_lib
from repro_torch.train import steps as steps_lib


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    # filled by the engine:
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves on ``model.device`` (an ``LM`` defaults to the card)."""

    def __init__(self, model: lm_lib.LM, params, batch_slots: int, cache_len: int):
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = batch_slots
        self.cache_len = cache_len
        self.state = model.init_decode_state(batch_slots, cache_len)
        self.slot_pos = np.full(batch_slots, -1, np.int64)  # -1 = free
        self.slot_req: list[Request | None] = [None] * batch_slots
        self._queue: list[Request] = []
        # every step decodes all slots and ignores the free ones
        self._step = steps_lib.make_serve_step(model)

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _admit(self) -> None:
        fresh = []
        for i in range(self.slots):
            if self.slot_req[i] is None and self._queue:
                self.slot_req[i] = self._queue.pop(0)
                self.slot_pos[i] = 0
                fresh.append(i)
        if fresh:
            lm_lib.reset_decode_rows(self.state, fresh)

    def step(self) -> None:
        """One engine tick: advance every occupied slot by one token."""
        self._admit()
        tokens = np.zeros(self.slots, np.int32)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            p = int(self.slot_pos[i])
            tokens[i] = req.prompt[p] if p < len(req.prompt) else req.generated[-1]
        pos = int(max(self.slot_pos.max(), 0))
        logits, self.state = self._step(
            self.params, self.state, torch.from_numpy(tokens).to(self.device), pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[i] += 1
            p = int(self.slot_pos[i])
            if p >= len(req.prompt):
                req.generated.append(int(nxt[i]))
            if len(req.generated) >= req.max_new_tokens or p + 1 >= self.cache_len:
                req.done = True
                self.slot_req[i] = None
                self.slot_pos[i] = -1

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self._queue and all(r is None for r in self.slot_req):
                return
            self.step()
        raise RuntimeError("serve engine did not drain")
