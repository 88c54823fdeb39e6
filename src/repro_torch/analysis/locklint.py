"""locklint — AST enforcement of the port's lock discipline.

Counterpart of ``repro/analysis/locklint.py``, with the same rules, and
run over every module of the port that holds a lock: the streaming
service, the trainer, the loader's prefetchers and the chunk cache, the
tracer and counters, the serve engine, and the kernels' shared scratch
and build cache. The class of bug it finds is a field written under
``self._vocab_lock`` read outside it, racing the service loop against
``refresh_vocab``. The rule:

  **A field assigned under ``with self.<lock>:`` anywhere in a class
  (outside ``__init__``) is owned by that lock, and every other read or
  write of it must also hold the lock.**

Lock attributes are recognized by construction
(``self.x = threading.Lock() / RLock() / Condition()``); ownership and
accesses are resolved lexically (code inside a ``with self.<lock>``
block — nested functions and lambdas included — holds the lock).
``__init__`` is exempt on both sides: construction happens-before any
concurrent access. A field written under several locks is satisfied by
holding any one of them.

Rules: LK401 (error) — unguarded *write* of an owned field;
LK402 (error) — unguarded *read*.

Escape hatch: a ``# locklint: ignore[LK402]`` (or bare
``# locklint: ignore``) comment on the offending line suppresses the
finding — for fields with a documented single-writer discipline that
the lexical analysis cannot see. Suppressions are deliberate review
artifacts; prefer them over baselining for anything with a comment-
worthy justification.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from repro_torch.analysis.findings import Finding

_LOCK_CTORS = ("Lock", "RLock", "Condition")
_IGNORE_RE = re.compile(r"#\s*locklint:\s*ignore(?:\[([A-Z0-9, ]+)\])?")


def _is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
    return name in _LOCK_CTORS


def _self_attr(node: ast.expr) -> str | None:
    """``self.X`` → ``"X"`` (else None)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _with_locks(node: ast.With, lock_names: set[str]) -> set[str]:
    held = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr in lock_names:
            held.add(attr)
    return held


def _suppressed(lines: list[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    m = _IGNORE_RE.search(lines[lineno - 1])
    if not m:
        return False
    rules = m.group(1)
    return rules is None or rule in {r.strip() for r in rules.split(",")}


class _Access:
    __slots__ = ("field", "kind", "held", "lineno", "method")

    def __init__(self, field, kind, held, lineno, method):
        self.field = field
        self.kind = kind  # "read" | "write"
        self.held = held  # frozenset of lock names held at the site
        self.lineno = lineno
        self.method = method


def _collect_accesses(
    cls: ast.ClassDef, lock_names: set[str]
) -> list[_Access]:
    """Every ``self.X`` access in the class with the lock set lexically
    held at that point. ``__init__`` is skipped entirely."""
    accesses: list[_Access] = []

    def walk(node, held: frozenset, method: str):
        if isinstance(node, ast.With):
            inner = held | _with_locks(node, lock_names)
            for child in node.body:
                walk(child, frozenset(inner), method)
            # context expressions themselves evaluate before acquisition
            for item in node.items:
                walk(item.context_expr, held, method)
            return
        if isinstance(node, ast.Attribute):
            field = _self_attr(node)
            if field is not None and field not in lock_names:
                kind = (
                    "write"
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                accesses.append(
                    _Access(field, kind, held, node.lineno, method)
                )
        for child in ast.iter_child_nodes(node):
            walk(child, held, method)

    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if item.name == "__init__":
                continue
            for child in item.body:
                walk(child, frozenset(), item.name)
    return accesses


def lint_source(
    src: str, path: str, *, root: str | None = None
) -> list[Finding]:
    """Lock-discipline findings for one module."""
    rel = path if root is None else os.path.relpath(path, root)
    tree = ast.parse(src)
    lines = src.splitlines()
    out: list[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        lock_names = {
            _self_attr(t)
            for n in ast.walk(cls)
            if isinstance(n, ast.Assign) and _is_lock_ctor(n.value)
            for t in n.targets
            if _self_attr(t)
        }
        if not lock_names:
            continue
        accesses = _collect_accesses(cls, lock_names)
        # ownership: field → set of locks it is written under
        owners: dict[str, set[str]] = {}
        for a in accesses:
            if a.kind == "write" and a.held:
                owners.setdefault(a.field, set()).update(a.held)
        for a in accesses:
            locks = owners.get(a.field)
            if not locks or a.held & locks:
                continue
            rule = "LK401" if a.kind == "write" else "LK402"
            if _suppressed(lines, a.lineno, rule):
                continue
            out.append(
                Finding(
                    rule=rule,
                    severity="error",
                    pass_name="locklint",
                    file=rel,
                    line=a.lineno,
                    obj=f"{cls.name}.{a.method}/{a.field}",
                    message=(
                        f"{a.kind} of {cls.name}.{a.field} in "
                        f"{a.method}() without holding "
                        f"{' or '.join(sorted(locks))} — the field is "
                        "written under that lock elsewhere (the "
                        "unguarded-read race class)"
                    ),
                )
            )
    return out


def lint_paths(paths: list[str], *, root: str | None = None) -> list[Finding]:
    out: list[Finding] = []
    for path in sorted(paths):
        with open(path) as f:
            out.extend(lint_source(f.read(), path, root=root))
    return out


# The port's modules that run on several threads (``threading.Lock`` /
# ``RLock`` / ``Condition`` holders), as globs under the repository root.
THREADED = (
    "src/repro_torch/stream/*.py",
    "src/repro_torch/train/*.py",
    "src/repro_torch/data/*.py",
    "src/repro_torch/obs/*.py",
    "src/repro_torch/serve/*.py",
    "src/repro_torch/kernels/_scratch.py",
    "src/repro_torch/kernels/_build.py",
)


def run(root: str) -> list[Finding]:
    """The whole pass: declared lock discipline over :data:`THREADED`."""
    paths = sorted({p for g in THREADED for p in glob.glob(os.path.join(root, g))})
    return lint_paths(paths, root=root)
