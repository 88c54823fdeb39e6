"""Service-side accounting for the streaming preprocessing service.

Counterpart of ``repro/stream/metrics.py``.

Two signals, matching how online preprocessing is judged (tf.data
service-style disaggregated deployments are provisioned on both):

  * **throughput** — valid rows emitted per wall-second over the serving
    window (first submit → last completion);
  * **request latency** — submit-to-result wall time per request, as
    p50/p95/p99 percentiles (the latency-bound view the offline engine
    never needed).

``ServiceMetrics`` is a **view over a** :class:`repro_torch.obs.Registry`, not
a private silo: the request/row counters and the latency histogram are
ordinary registry instruments (``stream.requests_total``,
``stream.rows_total``, ``stream.request_latency_s``), so the service's
stall buckets, queue gauges, and these numbers all come out of ONE
``registry.snapshot()``. The latency histogram keeps **exact** request
and row counts but a **bounded** reservoir for the percentiles
(:class:`repro_torch.obs.Histogram`) — the old per-request ``_latencies`` list
that grew one float forever is gone.

Thread-safe: the submitting threads and the service loop record
concurrently. ``snapshot()`` returns the same plain dict as always (the
JSON contract of ``benchmarks/stream_service.py``).
"""

from __future__ import annotations

import json
import threading
import time

from repro_torch import obs

PERCENTILES = (50.0, 95.0, 99.0)

# Latency percentiles are exact up to this many requests, reservoir-
# sampled beyond — bounding service memory at O(1) per instrument.
LATENCY_RESERVOIR = 4096


class ServiceMetrics:
    """Rows/s + p50/p95/p99 request-latency accounting (registry view)."""

    def __init__(self, registry: obs.Registry | None = None):
        self.registry = registry if registry is not None else obs.Registry()
        self._requests = self.registry.counter(
            "stream.requests_total", "completed requests"
        )
        self._rows = self.registry.counter(
            "stream.rows_total", "rows across completed requests"
        )
        self._latency = self.registry.histogram(
            "stream.request_latency_s",
            "submit-to-result seconds",
            reservoir=LATENCY_RESERVOIR,
        )
        self._lock = threading.Lock()
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None

    def note_submit(self, now: float | None = None) -> None:
        """Mark a request entering the service (opens the wall window)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._t_first_submit is None:
                self._t_first_submit = now

    def record(self, latency_s: float, n_rows: int, now: float | None = None) -> None:
        """Record one completed request."""
        now = time.perf_counter() if now is None else now
        self._requests.add(1)
        self._rows.add(int(n_rows))
        self._latency.observe(latency_s)
        with self._lock:
            self._t_last_done = now

    def reset(self) -> None:
        """Zero the request window (e.g. after warmup, so steady-state
        numbers exclude compile time). Only this view's instruments are
        touched — recompile counters, stall buckets, and the other
        registry instruments keep accumulating."""
        self._requests.reset()
        self._rows.reset()
        self._latency.reset()
        with self._lock:
            self._t_first_submit = None
            self._t_last_done = None

    def snapshot(self) -> dict:
        """Point-in-time summary: requests, rows, rows_per_s, p*_ms."""
        with self._lock:
            t0, t1 = self._t_first_submit, self._t_last_done
        n = self._latency.count
        rows = self._rows.value
        wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        out = {
            "requests": int(n),
            "rows": int(rows),
            "wall_s": round(wall, 6),
            "rows_per_s": round(rows / wall, 1) if wall > 0 else 0.0,
        }
        if n:
            pct = self._latency.percentiles(PERCENTILES)
            for p in PERCENTILES:
                out[f"p{p:g}_ms"] = round(pct[p] * 1e3, 3)
            out["mean_ms"] = round(self._latency.sum / n * 1e3, 3)
        else:
            for p in PERCENTILES:
                out[f"p{p:g}_ms"] = 0.0
            out["mean_ms"] = 0.0
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)
