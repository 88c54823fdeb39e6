"""kernelcheck — routes and declared launches against the card's limits, and
an audit of the CUDA sources' launches.

Counterpart of ``repro/analysis/kernelcheck.py``. The reference checks its
kernels' VMEM footprints against the TPU tier router and audits its
``pallas_call`` grids for carried-state races; the port has one
device-memory route at every vocab range and CUDA launches instead, so the
same two halves check what can go wrong there. The limits are sm_90's
documented per-block limits (:data:`SM90`); on the card
``torch.cuda.get_device_properties`` supplies them (:func:`device_limits`).
No measured time enters.

**Route and launch agreement (KC201, KC202).** ``CompiledPlan.static_routes``
declares each dispatch's route label and, from each kernel library's
``launch_accounting``, the grid, threads and dynamic shared bytes it
launches at ``max_rows`` rows. :func:`check_routes` flags a declared launch
past a limit, or an element count at or above 2**31 that the wrapper would
refuse (KC201, error), and a route label that disagrees with the kernel
entries the dispatch actually calls, counted by ``launch_audit`` on small
inputs (KC202, error). :func:`check_shape_matrix` sweeps the reference's
seven points: criteo-5k, criteo-1m, cutoff-width, budget-edge-in and -out,
counts-5k, and forced-slab, where ``PipelineConfig`` must refuse the slab
width (the reference's forced slab tier is deliberately not ported).

**Source audit of ``kernels/csrc`` (KC210, KC211).** Every ``<<<...>>>``
launch: a launch that passes dynamic shared bytes (anything but a literal
0) must opt in with ``cudaFuncSetAttribute(kernel,
cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` before it in the same
launcher, or above 48 KiB it is refused (KC210, error); the threads it
passes must not exceed the kernel's ``__launch_bounds__`` (KC211, error).
Threads are bounded by interval arithmetic over the translation unit's
``constexpr`` ints and one-line functions; a launch whose threads cannot be
bounded is reported (KC212, info).

**On the card only.** :func:`check_launch_configs` holds every library's
``launch_accounting`` to its ``<library>_launch_config`` (KC203, error), and
:func:`check_ptxas` reads each library's ``ptxas -v`` log kept beside it by
``_build.build``: registers x threads must fit the SM's 65536 (KC220),
static plus declared dynamic shared bytes the opt-in limit (KC221), and the
bf16 D-256 flash kernel must not spill (KC222), all errors.
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import math
import os
import re

from repro_torch.analysis.findings import Finding

# sm_90's documented per-block limits (CUDA C++ Programming Guide, compute
# capability 9.0): threads, dynamic shared bytes without and with the
# opt-in, grid extents, and the 32-bit registers of one SM.
SM90 = {
    "threads": 1024,
    "smem": 48 << 10,
    "smem_optin": 227 << 10,
    "grid_x": 2**31 - 1,
    "grid_yz": 65535,
    "registers": 65536,
}
CSRC = "src/repro_torch/kernels/csrc"
PLAN_COMPILER = "src/repro_torch/core/plan_compiler.py"
# The bf16 wgmma flash kernel at head_dim 256 (gemma-2b's), by its mangled
# name in ptxas's log; it must not spill.
FLASH_WGMMA_D256 = "flash_wgmma_kernelILi256E"
CARD_ONLY = (
    "kernelcheck: launch_accounting against each <library>_launch_config (KC203)",
    "kernelcheck: ptxas registers, shared bytes and spills (KC220-KC222)",
)


def device_limits(device=None) -> dict:
    """:data:`SM90`, with the shared-memory limits read from the card's
    properties when ``device`` is a CUDA device (the opt-in limit is the
    SM's shared memory less the 1 KiB it reserves for each block)."""
    limits = dict(SM90)
    if device is None:
        return limits
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return limits
    props = torch.cuda.get_device_properties(device)
    limits["smem"] = int(props.shared_memory_per_block)
    limits["smem_optin"] = int(
        getattr(props, "shared_memory_per_block_optin", 0)
        or props.shared_memory_per_multiprocessor - 1024
    )
    limits["registers"] = int(getattr(props, "regs_per_multiprocessor", 0) or SM90["registers"])
    return limits


def _finding(rule, severity, file, obj, message, line=0) -> Finding:
    return Finding(rule=rule, severity=severity, pass_name="kernelcheck", file=file,
                   line=line, obj=obj, message=message)


# --------------------------------------------------------------------- #
# route and launch agreement
# --------------------------------------------------------------------- #
def launch_problems(launch: dict, limits: dict) -> list[str]:
    """What in one declared launch the card would refuse."""
    out = []
    if launch["threads"] > limits["threads"]:
        out.append(f"{launch['threads']} threads a block > {limits['threads']}")
    if launch["grid_x"] > limits["grid_x"]:
        out.append(f"grid x {launch['grid_x']} > {limits['grid_x']}")
    if max(launch["grid_y"], launch["grid_z"]) > limits["grid_yz"]:
        out.append(f"grid y/z {launch['grid_y']}/{launch['grid_z']} > {limits['grid_yz']}")
    if launch["smem"] > limits["smem_optin"]:
        out.append(f"{launch['smem']} dynamic shared bytes > the opt-in limit "
                   f"{limits['smem_optin']}")
    elif launch["smem"] > limits["smem"] and launch["opt_in"] < launch["smem"]:
        out.append(f"{launch['smem']} dynamic shared bytes > {limits['smem']} without an "
                   f"opt-in (opts in to {launch['opt_in']})")
    return out


def check_routes(compiled, *, max_rows=None, context="plan", limits=None,
                 observe_rows: int = 64) -> list[Finding]:
    """Each dispatch of ``compiled``: its declared launches against the
    limits and the wrapper's element ceiling (KC201), and its route label
    against the kernel entries it calls on ``observe_rows`` rows (KC202)."""
    from repro_torch.analysis import launch_audit

    limits = limits or SM90
    out: list[Finding] = []
    routes = compiled.static_routes(max_rows=max_rows)
    for name, entry in routes.items():
        obj = f"{context}/{name}"
        for k in entry["kernels"]:
            if k["limit"] is not None and k["elements"] >= k["limit"]:
                out.append(_finding(
                    "KC201", "error", PLAN_COMPILER, obj,
                    f"{k['symbol']} at {max_rows} rows: {k['elements']} elements, at or above "
                    f"the {k['limit']} its wrapper refuses"))
            for launch in k["launches"] or ():
                for problem in launch_problems(launch, limits):
                    out.append(_finding(
                        "KC201", "error", PLAN_COMPILER, obj,
                        f"{k['symbol']} ({launch['kernel']}) at {max_rows} rows: {problem}"))
    observed = launch_audit.observe_routes(compiled, rows=observe_rows)
    for name, entry in routes.items():
        if name not in observed:
            continue
        want = sorted(k["entry"] for k in entry["kernels"])
        got = sorted(n for n, c in observed[name].items() for _ in range(c))
        if want != got:
            out.append(_finding(
                "KC202", "error", PLAN_COMPILER, f"{context}/{name}",
                f"route {entry['route']!r} declares kernel entries {want}, but one chunk of the "
                f"dispatch called {got}"))
    return out


def matrix_points():
    """The reference's shape matrix (``repro/analysis/kernelcheck.py``): the
    paper's two ranges, the reference's VMEM cutoff and budget edges (one
    device-memory route here, so the router must not move), tracked counts,
    and the reference's forced slab tier (``None``: refused)."""
    from repro_torch.core import schema as schema_lib

    cutoff = 512 * 1024  # the reference's per-column VMEM cutoff (VMEM_TIER_MAX)
    return [
        ("criteo-5k", schema_lib.CRITEO, {}),
        ("criteo-1m", schema_lib.CRITEO_1M, {}),
        ("cutoff-width", dataclasses.replace(schema_lib.CRITEO, vocab_range=cutoff), {}),
        ("budget-edge-in", dataclasses.replace(schema_lib.CRITEO, vocab_range=80_000), {}),
        ("budget-edge-out", dataclasses.replace(schema_lib.CRITEO, vocab_range=81_000), {}),
        ("counts-5k", schema_lib.CRITEO, {"track_counts": True}),
        ("forced-slab", schema_lib.CRITEO, None),
    ]


ROUTINGS = {  # the compiler's hints of each routing the matrix sweeps
    "fused": {"fused": True, "fused_vocab": True, "fused_decode": True},
    "kernels": {"use_kernels": True},
}


def check_shape_matrix(*, device="cpu", max_rows: int = 1 << 14, limits=None) -> list[Finding]:
    """:func:`check_routes` over :func:`matrix_points`, each compiled with
    the fused hints (the reference's sweep) and with ``use_kernels`` on the
    unfused chain, on ``device``."""
    from repro_torch.core import pipeline as pipeline_lib
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import plan_compiler

    out: list[Finding] = []
    for name, schema, kw in matrix_points():
        if kw is None:
            try:
                pipeline_lib.PipelineConfig(vocab_slab_range=1024, device=str(device))
            except NotImplementedError:
                continue  # the deliberate refusal: not a finding
            out.append(_finding(
                "KC202", "error", "src/repro_torch/core/pipeline.py", f"{name}/vocab",
                "PipelineConfig took vocab_slab_range=1024: the slab tier is not ported, and "
                "the loop-① kernels would ignore it"))
            continue
        for routing, hints in ROUTINGS.items():
            compiled = plan_compiler.compile_plan(
                plan_lib.criteo_default(schema), schema, device=device, **hints, **kw)
            context = name if routing == "fused" else f"{name}+{routing}"
            out.extend(check_routes(compiled, max_rows=max_rows, context=context, limits=limits))
    return out


# --------------------------------------------------------------------- #
# source audit of kernels/csrc
# --------------------------------------------------------------------- #
_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+)[uUlL]*|(?P<name>(?:std::)?[A-Za-z_]\w*(?:::\w+)*)"
    r"|(?P<op><=|>=|==|!=|<<|>>|&&|\|\||[-+*/%()?:,<>]))")


class _Expr:
    """Interval bounds of a C integer expression: ``bound(text)`` → (lo, hi),
    ``math.inf`` where a side is unknown. Names resolve to the translation
    unit's ``constexpr`` ints and one-line ``return`` functions; ``min``,
    ``max``, casts and ``sizeof`` of 4-byte types are understood. Any
    other name is a size or count known at run time: ``[0, inf)``."""

    def __init__(self, consts: dict, funcs: dict):
        self.consts, self.funcs = consts, funcs

    def bound(self, text: str, depth: int = 0) -> tuple[float, float]:
        text = re.sub(r"static_cast<[^<>]*>", "", text)
        text = re.sub(r"sizeof\((?:float|int|unsigned|uint32_t|int32_t)\)", "4", text)
        toks, pos = [], 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip() == "":
                    break
                return (-math.inf, math.inf)
            toks.append((m.lastgroup, m.group(m.lastgroup)))
            pos = m.end()
        self._toks, self._i, self._depth = toks, 0, depth
        try:
            v = self._ternary()
        except (IndexError, ValueError, RecursionError):
            return (-math.inf, math.inf)
        return v if self._i == len(toks) else (-math.inf, math.inf)

    def _peek(self):
        return self._toks[self._i][1] if self._i < len(self._toks) else None

    def _take(self):
        tok = self._toks[self._i]
        self._i += 1
        return tok

    def _ternary(self):
        cond = self._compare()
        if self._peek() != "?":
            return cond
        self._take()
        a = self._ternary()
        if self._take()[1] != ":":
            raise ValueError("ternary")
        b = self._ternary()
        return (min(a[0], b[0]), max(a[1], b[1]))

    def _compare(self):
        v = self._add()
        while self._peek() in ("<", ">", "<=", ">=", "==", "!=", "&&", "||"):
            self._take()
            self._add()
            v = (0, 1)
        return v

    def _add(self):
        v = self._mul()
        while self._peek() in ("+", "-"):
            op = self._take()[1]
            w = self._mul()
            v = (v[0] + w[0], v[1] + w[1]) if op == "+" else (v[0] - w[1], v[1] - w[0])
        return v

    def _mul(self):
        v = self._unary()
        while self._peek() in ("*", "/", "%"):
            op = self._take()[1]
            w = self._unary()
            if op == "*" and v[0] >= 0 and w[0] >= 0:
                v = (v[0] * w[0], v[1] * w[1])
            elif op == "/" and w[0] == w[1] and w[0] > 0 and v[0] >= 0:
                v = (v[0] // w[0], v[1] // w[0] if v[1] != math.inf else math.inf)
            elif op == "%" and w[0] == w[1] and w[0] > 0 and v[0] >= 0:
                v = (0, min(v[1], w[0] - 1))
            else:
                v = (-math.inf, math.inf)
        return v

    def _unary(self):
        if self._peek() == "-":
            self._take()
            v = self._unary()
            return (-v[1], -v[0])
        return self._primary()

    def _args(self):
        args = []
        if self._peek() != ")":
            args.append(self._ternary())
            while self._peek() == ",":
                self._take()
                args.append(self._ternary())
        if self._take()[1] != ")":
            raise ValueError("call")
        return args

    def _primary(self):
        kind, tok = self._take()
        if kind == "num":
            return (int(tok), int(tok))
        if tok == "(":
            v = self._ternary()
            if self._take()[1] != ")":
                raise ValueError("paren")
            return v
        if kind != "name":
            raise ValueError(tok)
        if self._peek() == "(":
            self._take()
            args = self._args()
            base = tok.removeprefix("std::")
            if base == "min" and args:
                return (min(a[0] for a in args), min(a[1] for a in args))
            if base == "max" and args:
                return (max(a[0] for a in args), max(a[1] for a in args))
            body = self.funcs.get(tok)
            if body is not None and self._depth < 8:
                return _Expr(self.consts, self.funcs).bound(body, self._depth + 1)
            return (0, math.inf)
        if tok in self.consts and self._depth < 8:
            return _Expr(self.consts, self.funcs).bound(self.consts[tok], self._depth + 1)
        return (0, math.inf)  # a size or count the launcher computes at run time


_CONST = re.compile(
    r"^(?:inline\s+)?constexpr\s+(?:int|int64_t|unsigned|uint32_t|size_t)\s+(\w+)\s*=\s*([^;]+);",
    re.M)
_FUNC = re.compile(
    r"^(?:inline\s+|__host__\s+|__device__\s+|constexpr\s+)*(?:int|int64_t)\s+(\w+)\s*\([^)]*\)"
    r"\s*\{\s*return\s+([^;]+);\s*\}", re.M)
_INCLUDE = re.compile(r'^#include\s+"([^"]+)"', re.M)
_BOUNDS = re.compile(r"__launch_bounds__\(\s*([^,)]+)(?:,[^)]*)?\)\s*(\w+)\s*\(")
_LAUNCH = re.compile(r"(\w+)\s*(?:<(?:[^<>;]|<[^<>;]*>)*>)?\s*<<<(.*?)>>>", re.S)


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"), src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _split_top(text: str) -> list[str]:
    """Split on the commas outside parentheses and angle brackets."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts]


def _unit(sources: dict, name: str, seen=None) -> list[str]:
    """``name`` and the csrc headers it includes, transitively."""
    seen = seen if seen is not None else []
    if name in seen or name not in sources:
        return seen
    seen.append(name)
    for inc in _INCLUDE.findall(sources[name]):
        _unit(sources, inc, seen)
    return seen


def _launcher_region(src: str, pos: int) -> str:
    """The text of the function enclosing ``pos``, from its header line."""
    start = 0
    for m in re.finditer(r"^[A-Za-z_][^\n;]*\(", src[:pos], re.M):
        start = m.start()
    return src[start:pos]


def audit_sources(sources: dict[str, str], *, prefix: str = CSRC) -> tuple[list[Finding], dict]:
    """KC210/KC211/KC212 over ``sources`` (file name → CUDA text, headers
    included). Returns the findings and, per ``__global__`` function, the
    largest thread count any launch of it passes (None: unbounded)."""
    clean = {n: _strip_comments(s) for n, s in sources.items()}
    bounds_of: dict[str, str] = {}  # kernel → its __launch_bounds__ threads expression
    kernel_file: dict[str, str] = {}
    for name, src in clean.items():
        for m in _BOUNDS.finditer(src):
            bounds_of[m.group(2)] = m.group(1)
            kernel_file[m.group(2)] = name
    out: list[Finding] = []
    threads_of: dict[str, float | None] = {}
    for name, src in sorted(clean.items()):
        unit = _unit(clean, name)
        consts, funcs = {}, {}
        for part in reversed(unit):
            consts.update(dict(_CONST.findall(clean[part])))
            funcs.update(dict(_FUNC.findall(clean[part])))
        expr = _Expr(consts, funcs)
        rel = f"{prefix}/{name}"
        for m in _LAUNCH.finditer(src):
            kernel, config = m.group(1), _split_top(m.group(2))
            line = src.count("\n", 0, m.start()) + 1
            obj = f"{name}/{kernel}@{line}"
            if len(config) < 2:
                continue
            smem = config[2] if len(config) > 2 else "0"
            region = _launcher_region(src, m.start())
            opted = re.search(
                rf"cudaFuncSetAttribute\(\s*{re.escape(kernel)}\b[^;]*"
                r"cudaFuncAttributeMaxDynamicSharedMemorySize", region)
            if not re.fullmatch(r"0[uUlL]*", smem) and not opted:
                out.append(_finding(
                    "KC210", "error", rel, f"{name}/{kernel}",
                    f"launch of {kernel} passes dynamic shared bytes ({smem}) with no "
                    "cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize, ...) "
                    "before it in its launcher: above 48 KiB the launch is refused", line))
            lo, hi = expr.bound(config[1])
            if hi == math.inf:
                threads_of[kernel] = None
                out.append(_finding(
                    "KC212", "info", rel, f"{name}/{kernel}",
                    f"the threads of this launch of {kernel} ({config[1]}) are not statically "
                    "bounded; the card's launch-config check covers them", line))
                continue
            if kernel not in threads_of or threads_of[kernel] is not None:
                threads_of[kernel] = max(threads_of.get(kernel) or 0, hi)
            if kernel in bounds_of:
                kfile = kernel_file[kernel]
                kconsts = {}
                for part in reversed(_unit(clean, kfile)):
                    kconsts.update(dict(_CONST.findall(clean[part])))
                b_lo, b_hi = _Expr(kconsts, funcs).bound(bounds_of[kernel])
                limit, what = b_hi, f"its __launch_bounds__({bounds_of[kernel]})"
            else:
                limit, what = SM90["threads"], "the block limit"
            if hi > limit:
                out.append(_finding(
                    "KC211", "error", rel, f"{name}/{kernel}",
                    f"launch of {kernel} passes up to {int(hi)} threads ({config[1]}), more "
                    f"than {what} = {limit}: the launch is refused", line))
    return out, threads_of


def read_sources(root: str) -> dict[str, str]:
    out = {}
    for path in sorted(glob.glob(os.path.join(root, CSRC, "*.cu*"))):
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def check_repo_kernels(root: str) -> list[Finding]:
    """The source audit over the repository's ``kernels/csrc``."""
    return audit_sources(read_sources(root))[0]


# --------------------------------------------------------------------- #
# on the card: launch configs and ptxas
# --------------------------------------------------------------------- #
def config_shapes() -> list[tuple]:
    """(wrapper module, symbol, shape) at the main path's shapes and their
    edges, for :func:`check_launch_configs`."""
    from repro_torch.kernels.decode_utf8 import ops as decode_ops
    from repro_torch.kernels.dense_xform import ops as dense_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_decode_vocab import ops as fdv_ops
    from repro_torch.kernels.fused_decode_xform import ops as fdx_ops
    from repro_torch.kernels.fused_vocab import ops as fv_ops
    from repro_torch.kernels.fused_xform import ops as fx_ops
    from repro_torch.kernels.vocab import ops as vocab_ops

    out = []
    for mod, sym in ((decode_ops, "decode_utf8"), (fdv_ops, "fused_decode_genvocab"),
                     (fdx_ops, "fused_decode_transform")):
        out += [(mod, sym, (n,)) for n in (1, 8192, 8193, 1 << 20, (1 << 14) * 640)]
    for sym in ("fused_genvocab", "fused_genvocab_counts"):
        out += [(fv_ops, sym, s) for s in ((16384, 26), (4096, 27), (1, 1), (33, 40))]
    for sym in ("fused_transform", "fused_mod_dense"):
        out += [(fx_ops, sym, s) for s in ((16384, 26, 13), (3, 1, 0), (1 << 20, 26, 13))]
    out += [(vocab_ops, "genvocab", s) for s in ((16384, 27), (1, 1))]
    out += [(vocab_ops, "apply_vocab", s) for s in ((16384, 27), (1, 1), (1 << 20, 26))]
    out += [(dense_ops, "dense_transform", s)
            for s in ((16384 * 13, 0), (16384 * 12, 1), (3, 0), ((1 << 22) * 13, 1))]
    out += [(eb_ops, "embedding_gather", s) for s in ((4096, 26, 64, 1), (4096, 26, 63, 0))]
    out += [(eb_ops, "embedding_gather_backward", s)
            for s in ((4096, 26, 5000, 64, 1, 1), (4096, 26, 10**6, 64, 0, 1),
                      (16384, 26, 5000, 64, 1, 1), (4095, 3, 7, 30, 1, 0), (0, 26, 5000, 64, 1, 1))]
    out += [(fa_ops, "flash_attention", (b, h, s, d, fa_ops.ROUTES[r][0]))
            for b, h, s, d, r in ((4, 8, 4096, 256, "wgmma"), (1, 8, 32768, 256, "wgmma"),
                                  (2, 4, 256, 128, "wgmma"), (2, 4, 256, 64, "wgmma"),
                                  (2, 4, 256, 32, "mma_sync"), (2, 4, 256, 16, "mma_sync"),
                                  (2, 4, 256, 64, "f32"), (1, 8, 4096, 256, "f32"))]
    return out


def _declared(mod, symbol, shape, actual: list[dict], device) -> list[dict]:
    """``launch_accounting`` with the card's own facts: the resident wave the
    C config reports as its cap, the SM count and shared bytes."""
    kw = {}
    params = inspect.signature(mod.launch_accounting).parameters
    if "wave" in params:
        kw["wave"] = actual[0]["cap"] if actual else None
    if "sms" in params:
        import torch

        props = torch.cuda.get_device_properties(device)
        kw.update(sms=props.multi_processor_count,
                  sm_shared_bytes=props.shared_memory_per_multiprocessor)
    return mod.launch_accounting(symbol, *shape, **kw)


def check_launch_configs(device=None) -> tuple[list[Finding], list[dict]]:
    """KC203: every ``launch_accounting`` at :func:`config_shapes` against its
    library's ``<library>_launch_config`` on the card. Returns the findings
    and one record a comparison."""
    from repro_torch.kernels import _build

    out, records = [], []
    for mod, symbol, shape in config_shapes():
        source = mod.__name__.split(".")[-2]  # kernels/<library>/ops.py
        actual = _build.launch_config(source, mod.LAUNCH_ENTRIES[symbol], *shape, device=device)
        full = _declared(mod, symbol, shape, actual, device)
        declared = [{k: v for k, v in d.items() if k != "kernel"} for d in full]
        same = declared == actual
        records.append({"library": source, "symbol": symbol, "shape": list(shape),
                        "kernels": [d["kernel"] for d in full], "launches": actual,
                        "equal": same})
        if not same:
            out.append(_finding(
                "KC203", "error", f"src/repro_torch/kernels/{source}/ops.py", f"{source}/{symbol}",
                f"launch_accounting{shape} declares {declared}, but {source}_launch_config "
                f"reports {actual}"))
    return out, records


def ptxas_table(log: str) -> dict[str, dict]:
    """Registers, static shared bytes and spill bytes per kernel entry
    function (its mangled name) in one ``nvcc -Xptxas -v`` log."""
    table, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = table.setdefault(m.group(1), {"registers": 0, "smem": 0, "spill_stores": 0,
                                                "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return table


def check_ptxas(tables: dict[str, dict], threads: dict[str, float | None],
                dynamic: dict[str, int], limits: dict) -> list[Finding]:
    """KC220-KC222 over ``tables`` (library → :func:`ptxas_table`):
    ``threads`` and ``dynamic`` give each ``__global__`` function's largest
    launched threads (the source audit) and declared dynamic shared bytes
    (the launch declarations)."""
    out = []
    for lib, table in sorted(tables.items()):
        rel = f"{CSRC}/{lib}.cu"
        for mangled, use in table.items():
            kernel = next((k for k in sorted(threads, key=len, reverse=True) if k in mangled),
                          None)
            n_threads = threads.get(kernel) or limits["threads"]
            if use["registers"] * n_threads > limits["registers"]:
                out.append(_finding(
                    "KC220", "error", rel, f"{lib}/{mangled}",
                    f"{use['registers']} registers x {int(n_threads)} threads > "
                    f"{limits['registers']} registers of an SM: the launch is refused"))
            dyn = dynamic.get(kernel, 0)
            if use["smem"] + dyn > limits["smem_optin"]:
                out.append(_finding(
                    "KC221", "error", rel, f"{lib}/{mangled}",
                    f"{use['smem']} static + {dyn} dynamic shared bytes > the opt-in limit "
                    f"{limits['smem_optin']}"))
            if FLASH_WGMMA_D256 in mangled and (use["spill_stores"] or use["spill_loads"]):
                out.append(_finding(
                    "KC222", "error", rel, f"{lib}/{mangled}",
                    f"the bf16 D-256 flash kernel spills ({use['spill_stores']} bytes stored, "
                    f"{use['spill_loads']} loaded)"))
    return out


def card_checks(root: str, device) -> tuple[list[Finding], dict]:
    """KC203 and KC220-KC222 on the card: builds every library, compares
    the launch configs and reads the ptxas logs. Returns the findings and
    the report (the comparisons and the ptxas table)."""
    from pathlib import Path

    from repro_torch.kernels import _build

    limits = device_limits(device)
    found, records = check_launch_configs(device)
    paths = _build.build()
    tables = {lib: ptxas_table(Path(f"{p}.log").read_text()) for lib, p in paths.items()}
    _, threads = audit_sources(read_sources(root))
    dynamic: dict[str, int] = {}
    for r in records:
        for kernel, launch in zip(r["kernels"], r["launches"]):
            dynamic[kernel] = max(dynamic.get(kernel, 0), launch["smem"])
    found += check_ptxas(tables, threads, dynamic, limits)
    return found, {"launch_configs": records, "ptxas": tables, "limits": limits}


def run(root: str, *, device=None) -> tuple[list[Finding], dict]:
    """The whole pass: the shape matrix on ``device`` (the CPU by
    default) and the source audit; on a CUDA ``device`` also the card's
    launch configs and ptxas logs. Returns the findings and the report,
    which names what was skipped."""
    import torch

    device = torch.device(device or "cpu")
    limits = device_limits(device)
    found = check_shape_matrix(device=device, limits=limits) + check_repo_kernels(root)
    report: dict = {"limits": limits}
    if device.type == "cuda":
        card, extra = card_checks(root, device)
        found += card
        report.update(extra)
    else:
        report["skipped"] = list(CARD_ONLY)
    return found, report
