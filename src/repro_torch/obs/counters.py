"""Metrics registry: counters, gauges, histograms with a snapshot contract.

Counterpart of ``repro/obs/counters.py``, kept as the port's own copy (the
port imports nothing of the JAX package). The pipeline-wide accounting
substrate (zero dependencies beyond numpy). Three instrument kinds,
matching how disaggregated preprocessing services are provisioned
(tf.data service autoscales workers off exactly these signals —
PAPERS.md, Audibert et al.):

  * :class:`Counter`   — monotonic accumulator (requests, rows, bytes,
    recompiles, cumulative stall seconds);
  * :class:`Gauge`     — last-write-wins level (ingress queue depth);
  * :class:`Histogram` — distribution with **exact** count/sum/min/max
    plus a **bounded** reservoir for percentiles (latency, backpressure
    wait, bucket occupancy). The reservoir is algorithm-R sampling with
    a deterministic per-instrument RNG (``random.Random(name)``, the
    reference's seed, so the same observations give the same quantiles),
    so memory is O(reservoir) no
    matter how many observations arrive — this is what fixes the old
    ``ServiceMetrics._latencies`` list that grew one float per request
    forever.

All instruments are thread-safe (submitting threads, the service loop,
and snapshot readers record concurrently). :meth:`Registry.snapshot`
returns a plain nested dict — the JSON contract of the ``BENCH_*.json``
metrics dumps — and :meth:`Registry.export_jsonl` appends timestamped
snapshot lines for trajectory tracking.
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np

# Default percentiles reported by Histogram.snapshot (matches the
# streaming service's latency contract).
PERCENTILES = (50.0, 95.0, 99.0)

# Default reservoir bound. 4096 float64 samples = 32 KiB per histogram —
# percentiles stay exact until the 4097th observation and statistically
# representative after (uniform reservoir sampling).
DEFAULT_RESERVOIR = 4096


class Counter:
    """Monotonic accumulator. ``add`` accepts ints or floats (stall
    buckets accumulate seconds)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def add(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (add {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        v = self.value
        return {"kind": self.kind, "value": int(v) if v == int(v) else v}


class Gauge:
    """Last-write-wins level."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(0.0)

    def snapshot(self) -> dict:
        v = self.value
        return {"kind": self.kind, "value": int(v) if v == int(v) else v}


class Histogram:
    """Distribution: exact count/sum/min/max + bounded percentile reservoir.

    Algorithm-R reservoir sampling: the first ``reservoir`` observations
    are kept verbatim (percentiles exact); afterwards each new
    observation replaces a uniformly random slot with probability
    ``reservoir/count``. The RNG is seeded per instrument name so runs
    are reproducible.
    """

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "", reservoir: int = DEFAULT_RESERVOIR
    ):
        if reservoir <= 0:
            raise ValueError(f"histogram {name} needs a positive reservoir")
        self.name = name
        self.help = help
        self.reservoir = int(reservoir)
        self._lock = threading.Lock()
        self._rng = random.Random(name)
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._samples) < self.reservoir:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.reservoir:
                    self._samples[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentiles(self, ps=PERCENTILES) -> dict[float, float]:
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {p: 0.0 for p in ps}
        arr = np.asarray(samples, dtype=np.float64)
        return {p: float(np.percentile(arr, p)) for p in ps}

    def reset(self) -> None:
        with self._lock:
            self._rng = random.Random(self.name)
            self._samples = []
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
            samples = list(self._samples)
        out = {
            "kind": self.kind,
            "count": count,
            "sum": round(total, 9),
            "min": lo if lo is not None else 0.0,
            "max": hi if hi is not None else 0.0,
            "mean": round(total / count, 9) if count else 0.0,
        }
        arr = (
            np.asarray(samples, dtype=np.float64) if samples else np.zeros(0)
        )
        for p in PERCENTILES:
            out[f"p{p:g}"] = (
                round(float(np.percentile(arr, p)), 9) if samples else 0.0
            )
        return out


class Registry:
    """Thread-safe get-or-create registry of named instruments.

    One registry per accounting domain: the module-level default
    (:func:`repro_torch.obs.metrics`) carries process-wide engine counters;
    each ``StreamingPreprocessService`` owns a private registry so
    concurrent/sequential services never mix their numbers (the
    per-service JSON contract stays exact).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"instrument {name!r} already registered as {inst.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", reservoir: int = DEFAULT_RESERVOIR
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, reservoir=reservoir)

    def get(self, name: str):
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def reset(self) -> None:
        """Zero every instrument (registrations survive)."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst.reset()

    def snapshot(self) -> dict:
        """``{name: {kind, ...}}`` — the machine-readable metrics dump."""
        with self._lock:
            insts = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in insts}

    def export_jsonl(self, path: str, extra: dict | None = None) -> None:
        """Append one timestamped snapshot line (the trajectory format)."""
        rec = {"unix_time": round(time.time(), 3), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


# Process-wide default registry: engine-level counters (chunks, rows,
# bytes) land here; services create their own (see class docstring).
_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT
