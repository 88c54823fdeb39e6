"""Content-addressed cache of preprocessed chunks (Seneca, PAPERS.md).

Counterpart of ``repro/data/chunk_cache.py``: the same keys on the same
bytes (``raw_digest`` and ``vocab_digest`` equal the reference's), the
same LRU, capacity, admission and spill tiers.

Multi-epoch DLRM training re-reads the same raw chunks — on Criteo-style
workloads the re-read traffic is heavily skewed (a handful of hot chunks
dominate). Preprocessing is deterministic: the loop-② output of a chunk
is a pure function of (raw bytes, compiled plan, frozen vocabulary), so
a re-read never needs to run the operator chain again. This module
caches that function:

    key = sha256(raw chunk bytes) ⊕ plan signature ⊕ vocab digest

The key is **content-addressed** on all three axes, which is what makes
it safe: a changed byte, a different preprocessing plan, or a refreshed
vocabulary each produce a different key, so a hit is *always* the
bit-identical preprocessed output — the cache can never change a trained
weight (pinned by tests/test_torch_chunk_cache.py and the
streaming service's tests).

Two tiers:

  * **memory** — an LRU of ``{label, dense, sparse}`` numpy tables,
    bounded by ``capacity_bytes`` with **admission by size**: an entry
    larger than ``admit_fraction`` of capacity is refused outright (one
    giant chunk must not flush the whole working set);
  * **disk (optional)** — evicted entries spill to ``<spill_dir>/<key>.npz``
    and promote back to memory on access, so a working set larger than
    RAM still short-circuits preprocessing at disk-read cost.

Every signal lands in an :class:`repro_torch.obs.Registry` (``cache.hits_total``,
``cache.misses_total``, ``cache.disk_hits_total``, ``cache.evictions_total``,
``cache.spilled_total``, ``cache.rejected_total``, plus ``cache.mem_bytes``
/ ``cache.items`` gauges) — pass the streaming service's registry so one
snapshot carries the service *and* its cache.

The consumer is :class:`repro_torch.stream.StreamingPreprocessService`
(``cache=`` knob): the service loop consults the cache per request
*before* loop-② dispatch — hits complete immediately, never touching the
scheduler — and inserts each miss's routed result on completion.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading

import numpy as np

import torch

from repro_torch.obs import counters as counters_lib

# Cached-table keys, in stored order.
FIELDS = ("label", "dense", "sparse")


# ---------------------------------------------------------------------- #
# content-addressed key components
# ---------------------------------------------------------------------- #
def raw_digest(payload) -> str:
    """sha256 of a raw request payload (utf8 byte array or binary
    ``{label, dense, sparse}`` column dict)."""
    h = hashlib.sha256()
    if isinstance(payload, dict):
        for k in sorted(payload):
            a = np.ascontiguousarray(payload[k])
            h.update(k.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    else:
        h.update(np.ascontiguousarray(np.asarray(payload, np.uint8)).tobytes())
    return h.hexdigest()


def plan_signature(config) -> str:
    """Digest of the preprocessing *program* a config runs.

    Built from the resolved :class:`~repro_torch.core.plan.PreprocPlan`
    (pure frozen data — its repr is a stable canonical form), the table
    schema, and the input format. The port's plan classes are its own, so
    the signature is stable within the port but not equal to the
    reference's. Deliberately excludes the fused/tier knobs:
    those select *how* the plan executes, and every engine path is pinned
    bit-identical on integer outputs (and identical-formula on dense), so
    they cannot change a cached value.
    """
    parts = (
        repr(config.resolved_plan()),
        repr(config.schema),
        str(config.input_format),
    )
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()[:16]


def _host(x) -> np.ndarray:
    """A tensor's (or array's) values as a host numpy array; a device
    tensor is copied back, which waits for the work that made it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def vocab_digest(vocabulary) -> str:
    """Digest of a frozen :class:`~repro_torch.core.vocab.Vocabulary`
    (table + sizes bytes). Recomputed by the service on every atomic vocab
    swap, so entries keyed to a superseded vocabulary simply stop
    matching. On the card this copies the table back: 104 MB at V = 10^6."""
    h = hashlib.sha256()
    h.update(_host(vocabulary.table).tobytes())
    h.update(_host(vocabulary.sizes).tobytes())
    return h.hexdigest()[:16]


def cache_key(raw: str, plan_sig: str, vocab_dig: str) -> str:
    """Compose the three content digests into one cache key."""
    return f"{raw[:32]}-{plan_sig}-{vocab_dig}"


def _entry_bytes(value: dict) -> int:
    return sum(int(np.asarray(v).nbytes) for v in value.values())


class ChunkCache:
    """Bounded LRU of preprocessed chunks with admission-by-size and an
    optional spill-to-disk npz tier. Thread-safe (client submit threads
    and the service loop hit it concurrently).

    Args:
      capacity_bytes: memory-tier bound (sum of stored array bytes).
      spill_dir: directory for the npz disk tier; None disables spilling
        (evicted entries are dropped).
      admit_fraction: max entry size as a fraction of ``capacity_bytes``;
        larger entries are rejected (``cache.rejected_total``) instead of
        evicting the working set.
      registry: where the hit/miss/eviction counters land (default: a
        private registry; pass the service's to get one joint snapshot).
    """

    def __init__(
        self,
        capacity_bytes: int = 256 << 20,
        *,
        spill_dir: str | None = None,
        admit_fraction: float = 0.25,
        registry: counters_lib.Registry | None = None,
    ):
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {capacity_bytes}")
        if not 0.0 < admit_fraction <= 1.0:
            raise ValueError(f"admit_fraction must be in (0, 1], got {admit_fraction}")
        self.capacity_bytes = int(capacity_bytes)
        self.admit_bytes = max(1, int(capacity_bytes * admit_fraction))
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.registry = registry if registry is not None else counters_lib.Registry()
        self._lock = threading.Lock()
        self._mem: collections.OrderedDict[str, dict] = collections.OrderedDict()
        self._bytes = 0
        r = self.registry
        self._c_hits = r.counter("cache.hits_total", "chunk-cache hits (mem + disk)")
        self._c_misses = r.counter("cache.misses_total", "chunk-cache misses")
        self._c_disk_hits = r.counter(
            "cache.disk_hits_total", "hits served by promoting a spilled entry"
        )
        self._c_evict = r.counter("cache.evictions_total", "LRU evictions")
        self._c_spill = r.counter("cache.spilled_total", "evictions written to disk")
        self._c_reject = r.counter(
            "cache.rejected_total", "entries refused by size admission"
        )
        self._g_bytes = r.gauge("cache.mem_bytes", "memory-tier resident bytes")
        self._g_items = r.gauge("cache.items", "memory-tier resident entries")

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    @property
    def mem_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def _spill_path(self, key: str) -> str:
        return os.path.join(self.spill_dir, f"{key}.npz")

    # ------------------------------------------------------------------ #
    def get(self, key: str) -> dict | None:
        """The cached ``{label, dense, sparse}`` table, or None. A hit is
        promoted to MRU (disk hits promote back into the memory tier).
        Returned arrays are the cache's own storage — treat as read-only."""
        with self._lock:
            hit = self._mem.get(key)
            if hit is not None:
                self._mem.move_to_end(key)
                self._c_hits.add(1)
                return hit
        if self.spill_dir is not None:
            path = self._spill_path(key)
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    value = {k: np.ascontiguousarray(z[k]) for k in z.files}
                self._c_hits.add(1)
                self._c_disk_hits.add(1)
                self._admit(key, value)
                return value
        self._c_misses.add(1)
        return None

    def put(self, key: str, value: dict) -> bool:
        """Insert a preprocessed table (arrays are copied). Returns False
        when the entry fails size admission."""
        # np.array (not ascontiguousarray): always copy, so the stored
        # entry never aliases the caller's batch storage — routed results
        # are contiguous row slices of a larger live array.
        value = {k: np.array(v) for k, v in value.items()}
        if _entry_bytes(value) > self.admit_bytes:
            self._c_reject.add(1)
            return False
        self._admit(key, value)
        return True

    def _admit(self, key: str, value: dict) -> None:
        nbytes = _entry_bytes(value)
        spill: list[tuple[str, dict]] = []
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._bytes -= _entry_bytes(old)
            self._mem[key] = value
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and len(self._mem) > 1:
                evicted_key, evicted = self._mem.popitem(last=False)
                self._bytes -= _entry_bytes(evicted)
                self._c_evict.add(1)
                if self.spill_dir is not None:
                    spill.append((evicted_key, evicted))
            self._g_bytes.set(self._bytes)
            self._g_items.set(len(self._mem))
        # npz writes happen outside the lock — eviction must not stall
        # concurrent lookups behind disk I/O.
        for evicted_key, evicted in spill:
            np.savez(self._spill_path(evicted_key), **evicted)
            self._c_spill.add(1)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Plain-dict counter snapshot (the ``BENCH_e2e.json`` contract)."""
        names = (
            "cache.hits_total",
            "cache.misses_total",
            "cache.disk_hits_total",
            "cache.evictions_total",
            "cache.spilled_total",
            "cache.rejected_total",
        )
        out = {}
        for n in names:
            c = self.registry.get(n)
            out[n.split(".", 1)[1]] = int(c.value) if c is not None else 0
        out["mem_bytes"] = self.mem_bytes
        out["items"] = len(self)
        return out
