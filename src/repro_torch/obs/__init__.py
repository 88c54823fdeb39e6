"""repro_torch.obs — pipeline-wide observability: spans, metrics, stall attribution.

Counterpart of ``repro/obs/__init__.py``. Instrumentation shared by the
port's engine (``PiperPipeline``) and its streaming service
(``repro_torch.stream``):

  * :mod:`repro_torch.obs.trace`    — thread-safe nested span tracer
    exported as Chrome/Perfetto trace-event JSON, bridged into
    ``torch.profiler.record_function`` and NVTX so host spans line up
    with device profiles;
  * :mod:`repro_torch.obs.counters` — counter/gauge/histogram registry
    with a ``snapshot()``/JSONL export contract (histograms carry exact
    count/sum plus a bounded percentile reservoir);
  * :mod:`repro_torch.obs.stall`    — exhaustive wall-time attribution
    (queue-wait / host-assembly / device-dispatch / vocab-merge).

Non-semantic: instrumentation never touches the computation (spans time
host blocks, launch nothing and synchronise nothing), and the port's
golden and bit-identity tests run with it enabled. Unlike the
reference's, the process tracer starts **off**: the port's offline loops
are host-bound, and a span on every chunk cost them measurably.
:func:`enable` turns it on; while it is off a span is a shared no-op
context manager, and the engine's loops enter none. A :class:`Tracer`
made apart (a service's, a test's) starts on.

``stage_spans`` (off by default) adds nested ``decode`` and
``transform`` spans inside each chunk span of the utf8 engine. The
reference splits its one jitted dispatch in two for them; the port's
decoded route already launches decode apart from the loop kernel, so
the spans change no launch, and the bytes-in route keeps its one launch
(the chunk span carries the route).
"""

from __future__ import annotations

import threading

from repro_torch.obs import counters as counters_lib
from repro_torch.obs import stall  # noqa: F401  (re-export module)
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.counters import Counter, Gauge, Histogram, Registry
from repro_torch.obs.stall import StallClock
from repro_torch.obs.trace import Tracer, validate_trace

_GLOBAL_TRACER = trace_lib.Tracer()
_GLOBAL_TRACER.enabled = False  # off until enable(): see the module docstring
_STAGE_SPANS = threading.Event()


def tracer() -> Tracer:
    """The process-wide tracer every engine records into (one timeline)."""
    return _GLOBAL_TRACER


def span(name: str, cat: str = "host", **labels):
    """Record a nested span on the global tracer (context manager)."""
    return _GLOBAL_TRACER.span(name, cat=cat, **labels)


def instant(name: str, cat: str = "host", **labels) -> None:
    """Record an instant marker on the global tracer."""
    _GLOBAL_TRACER.instant(name, cat=cat, **labels)


def enable() -> None:
    _GLOBAL_TRACER.enabled = True


def disable() -> None:
    _GLOBAL_TRACER.enabled = False


def enabled() -> bool:
    return _GLOBAL_TRACER.enabled


def metrics() -> Registry:
    """The process-wide default metrics registry (engine-level counters;
    services own private registries — see :class:`Registry`)."""
    return counters_lib.default_registry()


def set_stage_spans(on: bool) -> None:
    """Toggle fine-grained stage spans (nested decode / transform spans on
    the utf8 engine — see the module docstring). Off by default."""
    if on:
        _STAGE_SPANS.set()
    else:
        _STAGE_SPANS.clear()


def stage_spans() -> bool:
    return _STAGE_SPANS.is_set()


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "StallClock",
    "Tracer",
    "disable",
    "enable",
    "enabled",
    "instant",
    "metrics",
    "set_stage_spans",
    "span",
    "stage_spans",
    "stall",
    "tracer",
    "validate_trace",
]
