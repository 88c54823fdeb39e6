"""Stall attribution: split serving wall time into exhaustive buckets.

Counterpart of ``repro/obs/stall.py``.

"Understand Data Preprocessing for Effective End-to-End Training"
(PAPERS.md) shows the question that matters for an input pipeline is not
"how fast is it" but "*where does the wall clock go*" — without
per-stage attribution you cannot tell whether decode, vocab merging, or
host assembly is the bottleneck, which is exactly the claim Piper's
fused dataflow makes. :class:`StallClock` answers it with a lap-timer
discipline: the instrumented loop calls :meth:`lap` at every phase
boundary, so **every second of loop wall time lands in exactly one
bucket** and the bucket sums reconstruct the wall clock by construction
(the acceptance bound — Σ buckets within 5% of wall — holds up to clock
read jitter).

The streaming service's buckets:

  * ``queue_wait``      — blocking on / polling the bounded ingress
    (includes idle: a starved service shows up here, the "input stall"
    of the e2e papers);
  * ``host_assembly``   — gather + pad + pack into the fixed-shape chunk;
  * ``device_dispatch`` — launching the transform's kernels (and the
    copies in and out) *and* blocking on its result + routing rows back
    (the device-bound share);
  * ``vocab_merge``     — applying pending loop-① deltas (monoid merge,
    finalize, atomic swap).

Cumulative seconds live in ordinary registry counters
(``stall.<bucket>_s``) so the report is just a registry view; the
double-buffer overlap counter (``stream.overlap_assembly_s``, recorded
by the service) measures how much host work was hidden behind the
in-flight device step.
"""

from __future__ import annotations

import time

from repro_torch.obs import counters as counters_lib

# The exhaustive service-loop buckets (order = report order).
BUCKETS = ("queue_wait", "host_assembly", "device_dispatch", "vocab_merge")

_PREFIX = "stall"

# The exhaustive *trainer-loop* buckets: every second of a training loop
# is either blocked on input (the stall the e2e papers measure) or spent
# in/waiting on the train step. The overlapped input bridge
# (the reference's ``train/input_pipeline.py``) laps these around its iterator so
# overlap-on vs overlap-off runs are directly comparable.
E2E_BUCKETS = ("input_wait", "train_step")
E2E_PREFIX = "e2e"


class StallClock:
    """Lap timer attributing a loop's wall time to named buckets.

    Single-owner: only the instrumented loop thread calls
    :meth:`start`/:meth:`lap` (the underlying counters are thread-safe,
    so concurrent *readers* — snapshot/report — need no coordination).
    """

    def __init__(
        self,
        registry: counters_lib.Registry,
        buckets: tuple[str, ...] = BUCKETS,
        prefix: str = _PREFIX,
    ):
        self.registry = registry
        self.prefix = prefix
        self.buckets = tuple(buckets)
        self._counters = {
            b: registry.counter(f"{prefix}.{b}_s") for b in self.buckets
        }
        self._wall = registry.counter(f"{prefix}.wall_s")
        self._last: float | None = None

    def start(self) -> None:
        """Open the attribution window (loop entry)."""
        self._last = time.perf_counter()

    def lap(self, bucket: str) -> float:
        """Charge the time since the previous lap/start to ``bucket``
        and restart the segment. Returns the segment seconds."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self._counters[bucket].add(dt)
        self._wall.add(dt)
        return dt

    def stop(self, bucket: str = "queue_wait") -> None:
        """Close the window, charging the tail segment to ``bucket``."""
        if self._last is not None:
            self.lap(bucket)
            self._last = None


def report(
    registry: counters_lib.Registry,
    prefix: str = _PREFIX,
    buckets: tuple[str, ...] = BUCKETS,
) -> dict:
    """The stall-attribution snapshot: per-bucket seconds, fractions of
    attributed wall time, and the wall total.

    Reads only registry counters — any process holding the registry can
    build the report (benchmarks, the service, a future multi-host
    router scraping workers). ``buckets`` selects the clock being read:
    the service-loop :data:`BUCKETS` (default) or the trainer-loop
    :data:`E2E_BUCKETS`.
    """
    bucket_names = buckets
    buckets = {}
    for b in bucket_names:
        c = registry.get(f"{prefix}.{b}_s")
        buckets[b] = float(c.value) if c is not None else 0.0
    wall_c = registry.get(f"{prefix}.wall_s")
    wall = float(wall_c.value) if wall_c is not None else 0.0
    total = sum(buckets.values())
    out = {
        "buckets_s": {b: round(v, 6) for b, v in buckets.items()},
        "attributed_s": round(total, 6),
        "wall_s": round(wall, 6),
        "fractions": {
            b: round(v / total, 4) if total > 0 else 0.0
            for b, v in buckets.items()
        },
    }
    return out
