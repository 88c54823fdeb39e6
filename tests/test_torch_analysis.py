"""The port's static gate (repro_torch.analysis) on the CPU, held against the
JAX package's (repro.analysis):

  * planlint: every seeded negative of tests/test_analysis.py, built in
    both packages' plan IRs from the same spec, gives the same
    ``(rule, severity, obj)`` findings in both, and the stock plans lint
    clean in both;
  * locklint: the same findings as the reference's on its seeded sources
    and none over the reference's stream/ and train/; over the port's
    threaded modules none, with the two findings this gate first found
    shown on their earlier code;
  * the baseline diff and the CLI, as the reference's tests have them,
    and the committed baseline pinned empty;
  * kernelcheck: the shape matrix is clean, a seeded over-limit launch or
    element count gives KC201 and a seeded wrong route label KC202; the
    CUDA source audit has a seeded negative for each rule and the repo's
    csrc/ is clean;
  * the launch audit: hand-kernel entries count as one, fused routes
    dispatch strictly fewer than unfused (JX303), a host read of a CUDA
    tensor is JX301 while the two host guards are not, and the train steps
    keep their storage (JX310).

The checks that need the card are in tests/test_torch_cuda.py.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import locklint as jlocklint
from repro.analysis import planlint as jplanlint
from repro.core import pipeline as jpipeline
from repro.core import plan as jplan
from repro.core import schema as jschema
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import findings as findings_lib
from repro_torch.analysis import kernelcheck, launch_audit, locklint, planlint
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import plan as tplan
from repro_torch.core import plan_compiler as tcomp
from repro_torch.core import schema as tschema
from repro_torch.core import vocab as tvocab
from repro_torch.data import synth

ROOT = cli.repo_root()
SMALL = dict(n_dense=4, n_sparse=5, vocab_range=101)


def keys(findings):
    return sorted((f.rule, f.severity, f.obj) for f in findings)


def rules(findings):
    return sorted({f.rule for f in findings})


# --------------------------------------------------------------------- #
# planlint against the reference
# --------------------------------------------------------------------- #
# Each case: column specs as (kind, [(op, params)]), from tests/test_analysis.py.
PLAN_CASES = {
    "PL101": [("sparse", [("Modulus", {"range": 2**32}), ("GenVocab", {}), ("ApplyVocab", {})])],
    "PL102": [("sparse", [("GenVocab", {}), ("ApplyVocab", {})])],
    "PL103": [("sparse", [("Modulus", {"range": 7}), ("GenVocab", {}), ("ApplyVocab", {})])],
    "PL110": [("dense", [("Logarithm", {})])],
    "PL110-guarded": [("dense", [("Neg2Zero", {}), ("Logarithm", {})])],
    "PL120-neg2zero": [("dense", [("Neg2Zero", {}), ("Neg2Zero", {}), ("Logarithm", {})])],
    "PL120-clip": [("dense", [("Clip", {"lo": -3.0e9, "hi": 3.0e9}), ("Neg2Zero", {})])],
    "PL121": [("sparse", [("Modulus", {}), ("GenVocab", {})])],
}
EXPECTED = {"PL101": "PL101", "PL102": "PL102", "PL103": "PL103", "PL110": "PL110",
            "PL110-guarded": None, "PL120-neg2zero": "PL120", "PL120-clip": "PL120",
            "PL121": "PL121"}


def _plans(spec):
    def build(lib):
        return lib.PreprocPlan(tuple(
            lib.ColumnSpec(kind=kind, source=0, ops=tuple(lib.op(n, **p) for n, p in ops))
            for kind, ops in spec))

    return build(jplan), build(tplan)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planlint_seeded_negatives_match_the_reference(case):
    jp, tp = _plans(PLAN_CASES[case])
    want = jplanlint.lint_plan(jp, jschema.TableSchema(**SMALL))
    got = planlint.lint_plan(tp, tschema.TableSchema(**SMALL))
    assert keys(got) == keys(want)
    if EXPECTED[case] is None:
        assert got == []
    else:
        assert EXPECTED[case] in rules(got)
    assert all(f.file == "src/repro_torch/core/plan.py" for f in got)


@pytest.mark.parametrize("chunk_rows", [1 << 20, 2**31 + 1])
def test_planlint_positions_pl130_match_the_reference(chunk_rows):
    got = planlint.check_positions(chunk_rows)
    assert keys(got) == keys(jplanlint.check_positions(chunk_rows))
    assert rules(got) == ([] if chunk_rows == 1 << 20 else ["PL130"])


def test_planlint_row_ceiling_pl131_matches_the_reference(monkeypatch):
    from repro.core import vocab as jvocab

    for lib in (jvocab, tvocab):
        monkeypatch.setattr(lib, "MAX_ROWS", lib.NEVER + 1)
    got = planlint.check_positions(1 << 14)
    assert rules(got) == ["PL131"]
    assert keys(got) == keys(jplanlint.check_positions(1 << 14))


@pytest.mark.parametrize("name", ["criteo-5k", "criteo-1m", "crossed"])
def test_planlint_stock_plans_clean_in_both(name):
    jsch = {"criteo-1m": jschema.CRITEO_1M}.get(name, jschema.CRITEO)
    tsch = {"criteo-1m": tschema.CRITEO_1M}.get(name, tschema.CRITEO)
    make = "crossed_criteo" if name == "crossed" else "criteo_default"
    rows = tpipeline.PipelineConfig.max_rows_per_chunk
    assert rows == jpipeline.PipelineConfig().max_rows_per_chunk
    want = jplanlint.lint_plan(getattr(jplan, make)(jsch), jsch, plan_name=name,
                               max_rows_per_chunk=rows)
    got = planlint.lint_plan(getattr(tplan, make)(tsch), tsch, plan_name=name,
                             max_rows_per_chunk=rows)
    assert got == [] and want == []


# --------------------------------------------------------------------- #
# locklint against the reference
# --------------------------------------------------------------------- #
_RACE = '''
import threading

class Service:
    def __init__(self):
        self._vocab_lock = threading.Lock()
        self._pending_delta = None

    def refresh(self, delta):
        with self._vocab_lock:
            self._pending_delta = delta

    def loop_step(self):
        delta = self._pending_delta
        return delta
'''
_INIT_EXEMPT = '''
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._x = 0
        self._x = 1

    def read(self):
        return self._x
'''
LOCK_CASES = {
    "unguarded-read": (_RACE, ["LK402"]),
    "unguarded-write": (_RACE + "\n    def clobber(self):\n        self._pending_delta = None\n",
                        ["LK401", "LK402"]),
    "guarded": (_RACE.replace("        delta = self._pending_delta\n        return delta",
                              "        with self._vocab_lock:\n"
                              "            delta = self._pending_delta\n        return delta"), []),
    "ignored": (_RACE.replace("delta = self._pending_delta",
                              "delta = self._pending_delta  # locklint: ignore[LK402]"), []),
    "ignored-other-rule": (_RACE.replace("delta = self._pending_delta",
                                         "delta = self._pending_delta  # locklint: ignore[LK401]"),
                           ["LK402"]),
    "init-exempt": (_INIT_EXEMPT, []),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_locklint_seeded_sources_match_the_reference(case):
    src, want_rules = LOCK_CASES[case]
    got = locklint.lint_source(src, "scratch.py")
    assert keys(got) == keys(jlocklint.lint_source(src, "scratch.py"))
    assert rules(got) == want_rules


@pytest.mark.parametrize("package", ["stream", "train"])
def test_locklint_reference_packages_clean_in_both(package):
    import glob

    paths = glob.glob(f"{ROOT}/src/repro/{package}/*.py")
    assert paths
    assert locklint.lint_paths(paths, root=ROOT) == jlocklint.lint_paths(paths, root=ROOT) == []


def test_locklint_port_clean_and_covers_every_lock_holder():
    import glob

    assert locklint.run(ROOT) == []
    covered = {p for g in locklint.THREADED for p in glob.glob(f"{ROOT}/{g}")}
    holders = [p for p in glob.glob(f"{ROOT}/src/repro_torch/**/*.py", recursive=True)
               if "threading.Lock()" in open(p).read() and "/analysis/" not in p]
    assert holders and set(holders) <= covered


def test_locklint_finds_the_tracer_epoch_race_on_its_earlier_code():
    """The tracer read ``_t_epoch`` outside ``_lock`` in ``instant`` and
    ``_record`` while ``reset`` wrote it under the lock (LK402 twice)."""
    src = '''
import threading
import time

class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._t_epoch = time.perf_counter()

    def instant(self):
        return time.perf_counter() - self._t_epoch

    def _record(self, t0):
        return t0 - self._t_epoch

    def reset(self):
        with self._lock:
            self._t_epoch = time.perf_counter()
'''
    assert keys(locklint.lint_source(src, "trace.py")) == [
        ("LK402", "error", "Tracer._record/_t_epoch"), ("LK402", "error", "Tracer.instant/_t_epoch")]


def test_locklint_service_suppression_is_what_silences_reader_waits():
    """``_reader_waits`` reads ``_pending_event`` under its one caller's
    ``_vocab_lock``, which the lexical lint cannot see: without its
    reviewed suppression it is LK402."""
    path = f"{ROOT}/src/repro_torch/stream/service.py"
    src = open(path).read()
    assert locklint.lint_source(src, path, root=ROOT) == []
    bare = src.replace("  # locklint: ignore[LK402]", "")
    assert keys(locklint.lint_source(bare, path, root=ROOT)) == [
        ("LK402", "error", "StreamingPreprocessService._reader_waits/_pending_event")] * 2


# --------------------------------------------------------------------- #
# findings / baseline / CLI gate
# --------------------------------------------------------------------- #
def _finding(rule="LK402", obj="X.y/_f"):
    return findings_lib.Finding(rule=rule, severity="error", pass_name="locklint",
                                file="scratch.py", line=7, obj=obj, message="m")


def test_baseline_diff_new_and_stale():
    f = _finding()
    new, stale = findings_lib.diff_baseline([f], [])
    assert [x.key for x in new] == [f.key]
    baseline = [f.to_dict(), _finding(obj="gone/long-ago").to_dict()]
    new, stale = findings_lib.diff_baseline([f], baseline)
    assert new == []
    assert stale == [("LK402", "scratch.py", "gone/long-ago")]


def test_baseline_keys_ignore_line_churn():
    a, b = _finding(), _finding()
    object.__setattr__(b, "line", 99)
    assert a.key == b.key


def test_cli_strict_clean_passes(tmp_path, capsys):
    report = tmp_path / "report.json"
    rc = cli.main(["--passes", "planlint,locklint", "--baseline", "none", "--strict", "--json",
                   str(report), "--device", "cpu"])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["version"] == 1 and data["findings"] == []
    out = capsys.readouterr().out
    assert "planlint: 0 finding(s)" in out


def test_cli_strict_fails_on_stale_baseline(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps(findings_lib.dump_findings([_finding(obj="stale/entry")])))
    rc = cli.main(["--passes", "planlint", "--baseline", str(baseline), "--strict",
                   "--device", "cpu"])
    assert rc == 1
    assert "stale" in capsys.readouterr().out


def test_cli_rejects_unknown_pass():
    with pytest.raises(SystemExit):
        cli.main(["--passes", "nosuchpass"])


def test_repo_torch_baseline_is_reviewed_and_empty():
    # the committed steady state: zero residual findings. If a finding must
    # be baselined, review it and update this pin deliberately.
    assert findings_lib.load_baseline(f"{ROOT}/analysis/torch_baseline.json") == []


def test_gate_strict_exits_zero_and_names_the_card_only_checks():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new vs baseline, 0 stale" in r.stdout
    for what in kernelcheck.CARD_ONLY + cli.LAUNCHES_CARD_ONLY:
        assert f"skipped (needs the card): {what}" in r.stdout


# --------------------------------------------------------------------- #
# kernelcheck
# --------------------------------------------------------------------- #
def _compiled(**hints):
    sch = tschema.CRITEO
    return tcomp.compile_plan(tplan.criteo_default(sch), sch, device="cpu", **hints)


def test_kernelcheck_shape_matrix_clean():
    assert kernelcheck.check_shape_matrix() == []


def test_static_routes_declare_the_routes_and_their_bytes():
    c = _compiled(fused=True, fused_vocab=True, fused_decode=True)
    routes = c.static_routes()
    assert set(routes) == {"vocab", "xform", "decode_vocab"}
    assert set(c.static_routes(max_rows=1 << 14)) == set(routes) | {"decode_xform"}
    assert [routes[k]["route"] for k in ("vocab", "xform", "decode_vocab")] == [
        c.vocab_route, c.xform_route, c.decode_vocab_route]
    assert routes["vocab"]["bytes"]["state_stack"] == 4 * 26 * 5000
    assert routes["xform"]["bytes"]["table_stack"] == 4 * 26 * 5000
    assert routes["xform"]["kernels"][0]["launches"] is None
    launch = c.static_routes(max_rows=1 << 14)["xform"]["kernels"][0]["launches"][0]
    assert (launch["kernel"], launch["threads"]) == ("xform_kernel", 128)
    plain = _compiled().static_routes(max_rows=1 << 14)
    assert plain["vocab"]["kernels"] == plain["xform"]["kernels"] == []
    assert [k["symbol"] for k in plain["decode_xform"]["kernels"]] == ["decode_utf8"]
    kern = _compiled(use_kernels=True).static_routes(max_rows=1 << 14)
    assert [k["symbol"] for k in kern["xform"]["kernels"]] == ["apply_vocab", "dense_transform"]


def test_kernelcheck_over_limit_launch_kc201():
    c = _compiled(fused=True, fused_vocab=True)
    routes = c.static_routes(max_rows=1 << 14)
    routes["xform"]["kernels"][0]["launches"][0]["threads"] = 2048
    routes["vocab"]["kernels"][0]["launches"][0]["smem"] = 64 << 10  # no opt-in
    c.static_routes = lambda max_rows=None: routes
    found = kernelcheck.check_routes(c, max_rows=1 << 14, context="stub")
    # the decoded routes launch the same kernels after decode
    assert keys(found) == [("KC201", "error", f"stub/{n}")
                           for n in ("decode_vocab", "decode_xform", "vocab", "xform")]


def test_kernelcheck_elements_past_the_wrapper_kc201():
    found = kernelcheck.check_routes(_compiled(fused=True, fused_vocab=True),
                                     max_rows=1 << 27, context="huge")
    # 2^27 rows x 26 columns >= 2^31 on each kernel, the decoded routes'
    # decode (2^27 x 40 cells) too
    assert rules(found) == ["KC201"]
    assert {f.obj for f in found} == {f"huge/{n}" for n in
                                      ("vocab", "xform", "decode_vocab", "decode_xform")}


def test_kernelcheck_wrong_route_label_kc202():
    c = _compiled(fused=True, fused_vocab=True)
    routes = c.static_routes(max_rows=1 << 14)
    routes["xform"]["route"] = "unfused"
    routes["xform"]["kernels"] = []  # the label's kernels: none on the plain chain
    c.static_routes = lambda max_rows=None: routes
    found = kernelcheck.check_routes(c, max_rows=1 << 14, context="stub")
    assert keys(found) == [("KC202", "error", "stub/xform")]
    assert "fused_xform.fused_transform" in found[0].message


def test_kernelcheck_forced_slab_is_refused_by_the_config():
    with pytest.raises(NotImplementedError):
        tpipeline.PipelineConfig(vocab_slab_range=1024, device="cpu")


def test_declared_launches_fit_the_card_at_every_shape():
    for mod, symbol, shape in kernelcheck.config_shapes():
        for launch in mod.launch_accounting(symbol, *shape):
            assert kernelcheck.launch_problems(launch, kernelcheck.SM90) == [], (symbol, shape)


_CU_HEAD = """
#include "common.cuh"
namespace {
constexpr int kThreads = 256;
__global__ void __launch_bounds__(kThreads) k_bounded(float* x) {}
__global__ void k_free(float* x) {}
}  // namespace
"""


@pytest.mark.parametrize("case", ["KC210", "KC211", "KC212", "clean"])
def test_source_audit_seeded_negatives(case):
    body = {
        "KC210": "int launch(float* x, int bytes, cudaStream_t s) {\n"
                 "  k_free<<<1, 128, bytes, s>>>(x);\n  return 0;\n}\n",
        "KC211": "int launch(float* x, cudaStream_t s) {\n"
                 "  k_bounded<<<1, 2 * kThreads, 0, s>>>(x);\n  return 0;\n}\n",
        "KC212": "int launch(float* x, int threads, cudaStream_t s) {\n"
                 "  k_free<<<1, threads, 0, s>>>(x);\n  return 0;\n}\n",
        "clean": "int launch(float* x, int bytes, int n, cudaStream_t s) {\n"
                 "  cudaFuncSetAttribute(k_free, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n"
                 "  k_free<<<1, 32 * std::min(n, 32), bytes, s>>>(x);\n"
                 "  k_bounded<<<n, kThreads>>>(x);\n  return 0;\n}\n",
    }[case]
    found, threads = kernelcheck.audit_sources({"seeded.cu": _CU_HEAD + body})
    assert rules(found) == ([] if case == "clean" else [case])
    assert all(f.file == f"{kernelcheck.CSRC}/seeded.cu" for f in found)
    if case == "clean":
        assert threads == {"k_free": 1024, "k_bounded": 256}


def test_source_audit_repo_csrc_clean_and_bounded():
    found, threads = kernelcheck.audit_sources(kernelcheck.read_sources(ROOT))
    assert found == []
    assert threads["genvocab_warp_kernel"] == 1024 and threads["flash_wgmma_kernel"] == 384
    assert None not in threads.values()


def test_ptxas_rules_on_a_seeded_log():
    log = """ptxas info    : Compiling entry function '_Z10k_boundedPf' for 'sm_90a'
ptxas info    : Used 128 registers, 8448 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN18flash_wgmma_kernelILi256EEvv' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, 16 bytes smem
"""
    table = kernelcheck.ptxas_table(log)
    assert table["_Z10k_boundedPf"] == {"registers": 128, "smem": 8448, "spill_stores": 0,
                                        "spill_loads": 0}
    found = kernelcheck.check_ptxas({"seeded": table},
                                    {"k_bounded": 1024, "flash_wgmma_kernel": 384},
                                    {"k_bounded": 230000}, kernelcheck.SM90)
    assert rules(found) == ["KC220", "KC221", "KC222"]


# --------------------------------------------------------------------- #
# the launch audit
# --------------------------------------------------------------------- #
def test_count_dispatches_basics():
    one = torch.ones(8)
    assert launch_audit.count_dispatches(lambda x: x + 1, one) == 1
    # views and allocations launch nothing
    assert launch_audit.count_dispatches(lambda x: x.view(2, 4).t()[0] + 1, one) == 1
    assert launch_audit.count_dispatches(lambda x: torch.empty(4), one) == 0


def test_a_kernel_entry_counts_as_one():
    from repro_torch.core import ops as core_ops
    from repro_torch.core import vocab as vocab_lib
    from repro_torch.kernels.fused_xform import ops as fx_ops

    rng = np.random.default_rng(0)
    sparse = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 26)).astype(np.int32))
    dense = torch.from_numpy(rng.integers(-3, 99, (64, 13)).astype(np.int32))
    vocab = vocab_lib.Vocabulary(table=torch.zeros((26, 5000), dtype=torch.int32),
                                 sizes=torch.zeros(26, dtype=torch.int32))
    rec = launch_audit.trace_dispatches(fx_ops.fused_transform, vocab, sparse, dense)
    assert rec.entries == {"fused_xform.fused_transform": 1} and rec.total == 1
    # the plain chain it replaces dispatches many
    plain = launch_audit.trace_dispatches(
        lambda: core_ops.fused_transform(vocab, sparse, dense, use_kernel=False))
    assert plain.entries == {} and plain.total > 3


def test_jx303_fused_strictly_fewer_than_unfused():
    found, stats = launch_audit.check_fused_reduction()
    assert found == []
    assert stats["fused/vocab_step"] == stats["fused/transform"] == 1
    assert stats["fused/vocab_step"] < stats["unfused/vocab_step"]
    assert stats["fused/transform"] < stats["unfused/transform"]


def test_audit_compiled_plan_hot_path_clean():
    found, stats = launch_audit.audit_compiled_plan(
        _compiled(fused=True, fused_vocab=True, fused_decode=True), max_rows=1 << 14,
        context="criteo-5k")
    assert found == []
    assert stats == {f"criteo-5k/{n}": 1
                     for n in ("vocab_step", "transform", "vocab_step_bytes", "transform_bytes")}


def test_jx301_a_read_of_a_cuda_tensor_is_a_finding():
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(4, dtype=torch.int32, device="cuda")
        read = launch_audit.trace_dispatches(lambda: x.sum().item())
        stay = launch_audit.trace_dispatches(lambda: x.sum() + 1)
        found, _ = launch_audit.audit_calls({"read": lambda: bool(x.sum() > 0)}, "cpu",
                                            context="seeded")
    assert read.syncs == [("_local_scalar_dense", "cuda:0")]
    assert stay.syncs == []
    assert keys(found) == [("JX301", "error", "seeded/read")]
    # a CPU tensor's read waits for nothing
    assert launch_audit.trace_dispatches(lambda: int(torch.zeros(2).sum())).syncs == []


def test_jx301_row_ceiling_guard_is_no_finding():
    """check_row_ceiling returns at once for a CUDA tensor; the same guard
    without its device test would read it."""
    def unguarded(rows_seen, rows):
        if rows_seen.item() + rows > tvocab.MAX_ROWS:
            raise OverflowError

    with FakeTensorMode(allow_non_fake_inputs=True):
        seen = torch.zeros((), dtype=torch.int32, device="cuda")
        guard = launch_audit.trace_dispatches(tvocab.check_row_ceiling, seen, 100)
        bare = launch_audit.trace_dispatches(unguarded, seen, 100)
    assert guard.syncs == [] and guard.total == 0
    assert bare.syncs == [("_local_scalar_dense", "cuda:0")]


def test_jx301_stream_guard_reads_only_past_the_row_bound(monkeypatch):
    """build_state_stream reads rows_seen only once its row bound passes
    MAX_ROWS (the CPU stands in for the card here: its reads are counted).
    With the kernels on, the loop's other reads sit inside kernel entries."""
    import itertools

    buf, _ = synth.make_dataset(synth.SynthConfig(rows=200, seed=1))
    cfg = tpipeline.PipelineConfig(chunk_bytes=4096, max_rows_per_chunk=64, use_kernels=True,
                                   device="cpu")
    pipe = tpipeline.PiperPipeline(cfg)

    def loop():  # four chunks of ~20 rows, each counted as up to 64
        return pipe.build_state_stream(itertools.islice(synth.chunk_stream(buf, 4096), 4))

    quiet = launch_audit.trace_dispatches(loop, sync_devices=("cpu",))
    assert quiet.syncs == [] and quiet.entries["vocab.genvocab_update"] == 4
    monkeypatch.setattr(tvocab, "MAX_ROWS", 3 * 64 - 1)  # the bound passes at the third
    loud = launch_audit.trace_dispatches(loop, sync_devices=("cpu",))
    assert loud.syncs and {op for op, _ in loud.syncs} == {"_local_scalar_dense"}


def test_jx310_train_steps_keep_their_storage():
    assert launch_audit.audit_train_steps("cpu") == []
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    opt = {"m": [torch.zeros(3), torch.zeros(2)], "v": [torch.zeros(3), torch.zeros(2)],
           "step": torch.zeros((), dtype=torch.int32)}

    def reallocating():
        params[1].data = params[1].data + 1
        opt["v"][0] = opt["v"][0] * 2

    assert launch_audit.step_keeps_storage(reallocating, lambda: params, opt) == [
        "params[1]", "v[0]"]


def test_launch_audit_run_clean_on_the_cpu():
    found, stats = launch_audit.run(ROOT)
    assert found == []
    assert stats["criteo-5k/vocab_step"] > 0 and stats["criteo-5k/transform"] > 0
