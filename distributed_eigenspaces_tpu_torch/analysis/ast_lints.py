"""AST lint: the lock discipline over the port's threaded runtime.

Counterpart of the concurrency half of ``distributed_eigenspaces_tpu/
analysis/ast_lints.py``, copied as it is (pure AST, it needs no device).
The linter works on SOURCE TEXT (:func:`lint_concurrency_source`) so the
mutation self-tests can feed seeded-violation fixtures without touching the
tree; :func:`lint_concurrency` walks the real target files.

The host-sync half waits: the port runs eagerly and has no traced region
yet. Its counterpart comes with CUDA graphs (ROADMAP Queue 1 item 9g), where
a captured region may neither sync the host nor close over a tensor.

**Concurrency lint.** The threaded runtime's documented discipline
(docs/ANALYSIS.md "Lock discipline"):

1. *single lock order* — at most one lock held at a time unless the
   nested pair is declared in :data:`LOCK_ORDER` (currently empty: the
   runtime deliberately never nests);
2. *no blocking calls under a lock* — no thread ``join``, ``sleep``,
   event/future waits, or filesystem IO while holding a lock. Waiting
   on the HELD Condition itself is exempt (``Condition.wait`` releases
   the lock — the whole point), as is ``os.path.join`` (a string op);
3. *guarded shared writes* — an attribute ever written under a lock
   (outside ``__init__``) is a shared variable and must be written
   under that lock everywhere. Methods named ``*_locked`` are the
   repo's called-with-lock-held convention and count as guarded.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

#: the port's threaded files the concurrency lint gates (repo-relative)
CONCURRENCY_TARGETS = (
    "distributed_eigenspaces_tpu_torch/runtime/scheduler.py",
    "distributed_eigenspaces_tpu_torch/runtime/supervisor.py",
    "distributed_eigenspaces_tpu_torch/runtime/membership.py",
    "distributed_eigenspaces_tpu_torch/serving/registry.py",
)

#: the documented nesting order: (outer, inner) pairs that MAY nest.
#: Empty = the runtime holds at most one lock at a time — any nesting
#: is a violation until a pair is documented here AND in
#: docs/ANALYSIS.md.
LOCK_ORDER: tuple[tuple[str, str], ...] = ()

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore"}
_BLOCKING_ATTRS = {"join", "sleep", "_sleep", "wait", "wait_for", "result"}
_IO_CHAINS = {
    ("open",),
    ("os", "replace"), ("os", "fsync"), ("os", "rename"),
    ("os", "remove"), ("os", "makedirs"), ("os", "listdir"),
    ("np", "load"), ("np", "save"), ("np", "savez"),
    ("numpy", "load"), ("numpy", "save"), ("numpy", "savez"),
    ("json", "dump"), ("json", "load"),
    ("pickle", "dump"), ("pickle", "load"),
    ("shutil", "rmtree"), ("shutil", "copy"), ("shutil", "move"),
}


def _chain(node) -> tuple[str, ...]:
    """``a.b.c`` -> ("a", "b", "c"); non-name bases end the chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _loc(filename: str, node: ast.AST) -> str:
    return f"{filename}:{getattr(node, 'lineno', '?')}"


# -- concurrency lint --------------------------------------------------------


@dataclass
class _Scope:
    """Lint state for one class (or the module's top level)."""

    name: str
    lock_attrs: set[str] = field(default_factory=set)
    #: attr -> set of lock names it was written under
    written_locked: dict = field(default_factory=dict)
    #: attr -> list of (method, lineno) unlocked writes
    written_unlocked: dict = field(default_factory=dict)


def _lock_name_of(node) -> str | None:
    """The lock token a ``with`` item / call receiver refers to:
    ``self.X`` -> "self.X", bare local ``name`` -> "name"."""
    ch = _chain(node)
    if len(ch) == 2 and ch[0] == "self":
        return f"self.{ch[1]}"
    if len(ch) == 1:
        return ch[0]
    return None


def _is_lock_factory(call) -> bool:
    if not isinstance(call, ast.Call):
        return False
    ch = _chain(call.func)
    return bool(ch) and ch[-1] in _LOCK_FACTORIES and (
        len(ch) == 1 or ch[0] in ("threading", "th")
    )


def lint_concurrency_source(
    src: str,
    filename: str,
    *,
    lock_order: tuple[tuple[str, str], ...] = LOCK_ORDER,
) -> list[Violation]:
    """Lock-discipline lint over one file's source text."""
    tree = ast.parse(src, filename=filename)
    out: list[Violation] = []
    program = os.path.basename(filename)

    def lint_function(fn, scope: _Scope, known_locks: set[str]):
        method = fn.name
        guarded_method = method.endswith("_locked")

        def walk(node, held: tuple[str, ...]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # nested def: a new call frame — the lock is NOT held
                # at its definition's execution time
                lint_function(node, scope, known_locks)
                return
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    lk = _lock_name_of(item.context_expr)
                    if lk is not None and lk in known_locks:
                        if inner and lk not in inner and \
                                (inner[-1], lk) not in lock_order:
                            out.append(Violation(
                                program=program,
                                rule="lock-order",
                                message=(
                                    f"acquires {lk} while holding "
                                    f"{inner[-1]} — nesting outside the "
                                    "documented LOCK_ORDER (the runtime "
                                    "holds one lock at a time; document "
                                    "the pair in analysis/ast_lints.py "
                                    "+ docs/ANALYSIS.md or restructure)"
                                ),
                                location=_loc(filename, node),
                            ))
                        inner = inner + (lk,)
                for child in node.body:
                    walk(child, inner)
                return
            if isinstance(node, ast.Call):
                _check_call(node, held)
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    ch = _chain(t)
                    if len(ch) == 2 and ch[0] == "self":
                        attr = ch[1]
                        if held:
                            scope.written_locked.setdefault(
                                attr, set()
                            ).update(held)
                        elif guarded_method:
                            # *_locked convention: caller holds the lock
                            scope.written_locked.setdefault(attr, set())
                        elif method != "__init__":
                            scope.written_unlocked.setdefault(
                                attr, []
                            ).append((method, node.lineno))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        def _check_call(call, held):
            if not held:
                return
            ch = _chain(call.func)
            if not ch:
                return
            # held-Condition wait is the release-and-wait idiom
            if ch[-1] in ("wait", "wait_for"):
                recv = _lock_name_of(call.func.value) if isinstance(
                    call.func, ast.Attribute
                ) else None
                if recv is not None and recv in held:
                    return
            if ch[:2] == ("os", "path"):  # os.path.join is a string op
                return
            if ch[-1] == "join" and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Constant):
                return  # ", ".join(...) string idiom
            blocking = (
                ch[-1] in _BLOCKING_ATTRS
                or ch in _IO_CHAINS
                or (len(ch) == 1 and ch[0] == "open")
                or ch[-1] == "acquire"
            )
            if blocking:
                out.append(Violation(
                    program=program,
                    rule="blocking-under-lock",
                    message=(
                        f"calls {'.'.join(ch)}() while holding "
                        f"{held[-1]} — blocking (join/sleep/wait/IO/"
                        "acquire) under a lock stalls every thread "
                        "contending for it; move the call outside the "
                        "critical section"
                    ),
                    location=_loc(filename, call),
                ))

        for stmt in fn.body:
            walk(stmt, ())

    def lint_class(cls):
        scope = _Scope(name=cls.name)
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                val = node.value
                if _is_lock_factory(val):
                    for t in targets:
                        lk = _lock_name_of(t)
                        if lk is not None:
                            scope.lock_attrs.add(lk)
        known = set(scope.lock_attrs)
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lint_function(node, scope, known)
        for attr, locks in sorted(scope.written_locked.items()):
            for method, lineno in scope.written_unlocked.get(attr, ()):
                lock = sorted(locks)[0] if locks else "its lock"
                out.append(Violation(
                    program=program,
                    rule="unguarded-shared-write",
                    message=(
                        f"{scope.name}.{attr} is written under {lock} "
                        f"elsewhere but written WITHOUT it in "
                        f"{method}() — a shared mutable attribute must "
                        "be touched only under its documented lock "
                        "(or from a *_locked method)"
                    ),
                    location=f"{filename}:{lineno}",
                ))

    # module-level functions get the blocking/nesting checks with any
    # locally-created locks (closure locks like estimators' fold_lock)
    mod_scope = _Scope(name="<module>")
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            lint_class(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_locks = {
                lk for n in ast.walk(node)
                if isinstance(n, ast.Assign) and _is_lock_factory(n.value)
                for lk in [_lock_name_of(n.targets[0])] if lk is not None
            }
            lint_function(node, mod_scope, local_locks)
    return out


def lint_concurrency(root: str | None = None) -> list[Violation]:
    """The lock-discipline lint over every runtime target file."""
    root = root or _repo_root()
    out: list[Violation] = []
    for rel in CONCURRENCY_TARGETS:
        path = os.path.join(root, rel)
        with open(path, encoding="utf-8") as f:
            out += lint_concurrency_source(f.read(), rel)
    return out


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
