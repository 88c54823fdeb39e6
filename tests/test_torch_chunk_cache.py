"""The port's content-addressed chunk cache (repro_torch.data.chunk_cache)
on the CPU: its key digests equal the JAX package's on the same bytes and
vocabulary, its plan signature is stable and tells plans apart, and its
LRU, capacity, admission and spill tiers behave as the reference's
(tests/test_e2e_overlap.py's cache unit tests, run here on the port)."""

import threading

import numpy as np
import pytest
import torch

from repro.core import vocab as jvocab
from repro.data import chunk_cache as jcc
from repro_torch import interop
from repro_torch.core import pipeline as TP
from repro_torch.core import plan as tplan
from repro_torch.core import schema as tschema
from repro_torch.core import vocab as tvocab
from repro_torch.data import chunk_cache as cc
from repro_torch.data import synth as tsynth


def _table(seed: int, rows: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "label": rng.integers(0, 2, rows).astype(np.int32),
        "dense": rng.integers(0, 100, (rows, 3)).astype(np.int32),
        "sparse": rng.integers(0, 50, (rows, 4)).astype(np.int32),
    }


def _entry_nbytes(t: dict) -> int:
    return sum(v.nbytes for v in t.values())


@pytest.mark.parametrize("kind", ["utf8", "binary"])
def test_raw_digest_equals_the_reference(criteo_small, kind):
    buf, table, _ = criteo_small
    payloads = list(tsynth.request_payloads(buf, table, [1, 7, 100], input_format=kind))
    for p in payloads:
        assert cc.raw_digest(p) == jcc.raw_digest(p)
    assert len({cc.raw_digest(p) for p in payloads}) == len(payloads)


def test_vocab_digest_equals_the_reference(criteo_small):
    """The digest of the port's vocabulary (torch tensors) equals the
    reference's digest of the same table and sizes (numpy)."""
    buf, _, cfg = criteo_small
    pipe = TP.PiperPipeline(TP.PipelineConfig(schema=cfg.schema, device="cpu"))
    vocab = tvocab.finalize(pipe.build_state_stream(tsynth.chunk_stream(buf, 16384)))
    table, sizes = interop.vocabulary_to_numpy(vocab)
    assert cc.vocab_digest(vocab) == jcc.vocab_digest(jvocab.Vocabulary(table=table, sizes=sizes))
    other = tvocab.Vocabulary(table=vocab.table.clone(), sizes=vocab.sizes.clone())
    other.table[0, 0] += 1
    assert cc.vocab_digest(other) != cc.vocab_digest(vocab)
    assert cc.cache_key("a" * 64, "p", "v") == jcc.cache_key("a" * 64, "p", "v")


def test_plan_signature_is_stable_and_tells_plans_apart():
    sch = tschema.CRITEO
    default = TP.PipelineConfig(schema=sch, device="cpu")
    assert cc.plan_signature(default) == cc.plan_signature(
        TP.PipelineConfig(schema=sch, device="cpu", plan=tplan.criteo_default(sch)))
    crossed = TP.PipelineConfig(schema=sch, device="cpu", plan=tplan.crossed_criteo(sch))
    assert cc.plan_signature(crossed) != cc.plan_signature(default)
    # execution hints do not change the program
    hinted = TP.PipelineConfig(schema=sch, device="cpu", use_kernels=True,
                               use_fused_decode=True, max_rows_per_chunk=64)
    assert cc.plan_signature(hinted) == cc.plan_signature(default)
    # the format and the vocab range do
    assert cc.plan_signature(TP.PipelineConfig(schema=sch, device="cpu",
                                               input_format="binary")) != cc.plan_signature(default)
    wider = TP.PipelineConfig(schema=tschema.CRITEO_1M, device="cpu")
    assert cc.plan_signature(wider) != cc.plan_signature(default)


def test_cache_roundtrip_and_copy_isolation():
    cache = cc.ChunkCache(capacity_bytes=1 << 20)
    src = _table(0)
    cache.put("k", src)
    src["label"][:] = -1  # caller mutates AFTER put: stored copy unaffected
    got = cache.get("k")
    assert got is not None and np.all(got["label"] >= 0)
    assert cache.get("absent") is None
    st = cache.stats()
    assert st["hits_total"] == 1 and st["misses_total"] == 1
    assert st["items"] == 1 and st["mem_bytes"] == _entry_nbytes(got)


def test_cache_lru_eviction_and_capacity():
    one = _entry_nbytes(_table(0))
    cache = cc.ChunkCache(capacity_bytes=3 * one, admit_fraction=1.0)
    for i in range(3):
        cache.put(f"k{i}", _table(i))
    cache.get("k0")  # promote k0 to MRU → k1 is now LRU
    cache.put("k3", _table(3))
    assert cache.get("k1") is None  # evicted
    assert cache.get("k0") is not None and cache.get("k3") is not None
    assert cache.mem_bytes <= 3 * one
    assert cache.stats()["evictions_total"] == 1


def test_cache_admission_rejects_oversize():
    one = _entry_nbytes(_table(0))
    cache = cc.ChunkCache(capacity_bytes=10 * one, admit_fraction=0.05)
    assert not cache.put("big", _table(0))  # > 5% of capacity
    assert len(cache) == 0
    assert cache.stats()["rejected_total"] == 1
    for bad in ({"capacity_bytes": 0}, {"capacity_bytes": 8, "admit_fraction": 0.0}):
        for lib in (cc, jcc):
            with pytest.raises(ValueError):
                lib.ChunkCache(**bad)


def test_cache_spill_and_promote(tmp_path):
    one = _entry_nbytes(_table(0))
    cache = cc.ChunkCache(capacity_bytes=2 * one, spill_dir=str(tmp_path), admit_fraction=1.0)
    tables = {f"k{i}": _table(i) for i in range(3)}
    for k, t in tables.items():
        cache.put(k, t)
    st = cache.stats()
    assert st["evictions_total"] == 1 and st["spilled_total"] == 1
    got = cache.get("k0")
    for f in cc.FIELDS:
        np.testing.assert_array_equal(got[f], tables["k0"][f])
    assert cache.stats()["disk_hits_total"] == 1
    assert len(cache) == 2  # promotion evicted the next LRU


def test_cache_thread_safety():
    cache = cc.ChunkCache(capacity_bytes=1 << 22)
    errs = []

    def worker(seed):
        try:
            for i in range(50):
                cache.put(f"k{(seed + i) % 7}", _table(i))
                cache.get(f"k{i % 7}")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs


def test_same_operations_same_stats_as_the_reference():
    """One sequence of puts and gets leaves the port's cache and the
    reference's with equal stats and equal entries."""
    one = _entry_nbytes(_table(0))
    caches = [lib.ChunkCache(capacity_bytes=4 * one, admit_fraction=0.5) for lib in (cc, jcc)]
    rng = np.random.default_rng(0)
    for step in range(200):
        k = f"k{int(rng.integers(0, 9))}"
        for cache in caches:
            if step % 3:
                cache.get(k)
            else:
                cache.put(k, _table(int(k[1:])))
    assert caches[0].stats() == caches[1].stats()
    assert list(caches[0]._mem) == list(caches[1]._mem)
    assert isinstance(cc.vocab_digest(tvocab.Vocabulary(
        table=torch.zeros((2, 3), dtype=torch.int32), sizes=torch.zeros(2, dtype=torch.int32))),
        str)
