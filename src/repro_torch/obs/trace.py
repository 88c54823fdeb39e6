"""Thread-safe span tracer with Chrome/Perfetto trace-event export.

Counterpart of ``repro/obs/trace.py``. The host-side timeline of the
preprocessing pipeline: nested spans with string labels, recorded into a
bounded ring and exported as the Chrome trace-event JSON that
``ui.perfetto.dev`` / ``chrome://tracing`` load directly
(`{"traceEvents": [...]}` with ``ph:"X"`` complete events — nesting is
implied by containment of ``[ts, ts+dur]`` within a thread track, so the
service loop's ``stream/assemble`` → ``loop2/chunk`` hierarchy renders
as a flame graph per thread).

Alignment with device profiles: while a ``torch.profiler`` session is
recording, every span also enters ``torch.profiler.record_function``, so
the same span names appear on the host track of the profiler's trace,
above the kernels they launched; on a CUDA tracer every span is also an
NVTX range (``torch.cuda.nvtx.range_push``/``range_pop``) for tools that
read NVTX. Outside a profiler session no ``record_function`` is entered
(it costs microseconds a span), and neither bridge launches anything or
synchronises the device.

Semantics (documented, not implied): a span measures **host wall time of
the enclosed block**. For asynchronous CUDA work that is the time to
*launch* the kernels, not to finish them — device completion shows up in
the explicit wait spans (``device/wait``) and in the stall attribution
(:mod:`repro_torch.obs.stall`).

A tracer is on when made, with a bounded ring (oldest events drop, a
counter records how many): one perf_counter pair plus one deque append
per span. ``Tracer.enabled = False`` turns a span into a shared no-op
context manager. The process tracer of :mod:`repro_torch.obs` starts
off (:func:`repro_torch.obs.enable`).

Run as a module to validate a trace file against the schema::

    python -m repro_torch.obs.trace out.json
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import torch

# Bounded ring: 64Ki events ≈ a few MB of host memory at the rate the
# engines emit (a handful of spans per chunk).
DEFAULT_MAX_EVENTS = 1 << 16

_VALID_PH = {"X", "i", "I", "M", "C", "B", "E"}

# The process id stamped on every event, read once: os.getpid() is a
# system call, dearer than the rest of a span on a sandboxed host. A
# forked child reads its own.
_PID = os.getpid()


def _reset_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_reset_pid)


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a ``ph:"X"`` event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_function", "_nvtx")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._function = None
        self._nvtx = False

    def __enter__(self):
        tracer = self._tracer
        if tracer.annotate:
            if torch.autograd._profiler_enabled():
                self._function = torch.profiler.record_function(self.name)
                self._function.__enter__()
            if tracer.nvtx:
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._function is not None:
            self._function.__exit__(*exc)
        self._tracer._record(self.name, self.cat, self._t0, t1, self.args)
        return False


class Tracer:
    """Bounded, thread-safe trace-event recorder.

    Args:
      max_events: ring capacity; the oldest events drop beyond it and
        ``dropped`` counts them (the export embeds the count as process
        metadata so a truncated trace is self-describing).
      annotate: bridge spans into ``torch.profiler.record_function``
        (while a profiler records) and, on a CUDA tracer, NVTX ranges, so
        host spans line up with device profiles.

    The tracer's device is ``"cuda"`` when a card is present (read at the
    first span, not at import), else ``"cpu"``.
    """

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS, annotate: bool = True):
        self.enabled = True
        self.annotate = annotate
        self._device: str | None = None
        self._nvtx: bool | None = None
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._appended = 0
        self._t_epoch = time.perf_counter()
        self._thread_names: dict[int, str] = {}

    @property
    def device(self) -> str:
        if self._device is None:
            self._device = "cuda" if torch.cuda.is_available() else "cpu"
        return self._device

    @property
    def nvtx(self) -> bool:
        """Whether spans are also NVTX ranges (a CUDA tracer)."""
        if self._nvtx is None:
            self._nvtx = torch.device(self.device).type == "cuda"
        return self._nvtx

    # -- recording ----------------------------------------------------- #
    def span(self, name: str, cat: str = "host", **labels):
        """Context manager timing the enclosed block as one complete
        event. ``labels`` become the event's ``args`` (stringified)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, labels)

    def instant(self, name: str, cat: str = "host", **labels) -> None:
        """Zero-duration marker (``ph:"i"``) — vocab refresh arrivals,
        swap applications, error events."""
        if not self.enabled:
            return
        self._append(
            time.perf_counter(),
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "pid": _PID,
                "tid": threading.get_ident(),
                "args": {k: _argstr(v) for k, v in labels.items()},
            }
        )

    def _record(self, name, cat, t0, t1, labels) -> None:
        self._append(
            t0,
            {
                "name": name,
                "cat": cat,
                "ph": "X",
                "dur": (t1 - t0) * 1e6,
                "pid": _PID,
                "tid": threading.get_ident(),
                "args": {k: _argstr(v) for k, v in labels.items()},
            }
        )

    def _append(self, t: float, event: dict) -> None:
        """Record ``event`` at ``t`` (a ``time.perf_counter`` reading).
        Its ``ts`` is taken against the epoch under the lock that
        :meth:`reset` holds to move the epoch, so an event recorded
        during a reset never mixes the old epoch with the new ring."""
        tid = event["tid"]
        with self._lock:
            event["ts"] = (t - self._t_epoch) * 1e6
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(event)
            self._appended += 1

    # -- inspection / export ------------------------------------------- #
    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._appended - len(self._events))

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._appended = 0
            self._t_epoch = time.perf_counter()

    def to_chrome(self) -> dict:
        """The Perfetto-loadable document: thread-name metadata events
        first, then the recorded events in arrival order."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
            dropped = max(0, self._appended - len(events))
        pid = _PID
        meta: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "repro-preprocess"},
            }
        ]
        for tid, tname in sorted(names.items()):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def _argstr(v):
    """Event args must be JSON scalars; keep numbers, stringify the rest."""
    return v if isinstance(v, (int, float, bool, str)) else str(v)


# --------------------------------------------------------------------- #
# schema validation (the CI obs job runs this over the smoke trace)
# --------------------------------------------------------------------- #
def validate_trace(doc: dict) -> list[str]:
    """Structural check against the trace-event format. Returns a list
    of problems (empty = Perfetto-loadable as far as the schema goes)."""
    errors: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a 'traceEvents' array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    if not events:
        errors.append("'traceEvents' is empty")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            errors.append(f"{where}: pid/tid must be ints")
        if ph in ("X", "i", "I", "B", "E", "C"):
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"{where}: {ph} event needs numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs non-negative dur")
        args = ev.get("args", {})
        if not isinstance(args, dict):
            errors.append(f"{where}: args must be an object")
    return errors


def _main(argv: list[str]) -> int:
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.trace <trace.json>")
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    errors = validate_trace(doc)
    n = len(doc.get("traceEvents", [])) if isinstance(doc, dict) else 0
    if errors:
        for e in errors:
            print(f"INVALID: {e}")
        return 1
    print(f"OK: {argv[0]} — {n} trace events, schema valid")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
