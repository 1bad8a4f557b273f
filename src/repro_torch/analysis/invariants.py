"""AST-based static checker for the port's serving-stack invariants
(RI001-RI007).

Port of ``repro.analysis.invariants``: the same rules, codes, messages and
suppression comments, so the two checkers agree on a line.  It reads the
port's contracts (``repro_torch.analysis.contracts``) and anchors relative
imports at the ``repro_torch`` package, so RI004 sees the port's host-only
modules.  Pure stdlib.  Each rule has an error code, precise ``file:line``
reporting, and per-line suppression via a trailing
``# repro: allow[RI00x]`` comment (comma-separated codes; place it on the
*first* line of the offending statement).  The contracts themselves
(which classes are frozen, the lock order, the host-only module list,
...) live in ``repro_torch.analysis.contracts``.

Rules
-----
RI001  no attribute assignment / ``del`` on frozen-contract instances
       (``SegmentTable``, ``Snapshot``, ``ShardSet``, ``IndexPlan``, result
       types) outside their own ``__init__``/``__post_init__`` or the
       declared setattr allowlist (``object.__setattr__`` included).
RI002  no double-deref of a swap-on-publish handle field (``_shard_set``,
       ``_state``, ``*_handle``, ``*_snapshot``) within one function -- pin
       the current value to a local once, then use the local.
RI003  no in-place numpy mutation (``x[...] = ``, ``+=``, ``.sort()``,
       ``.fill()``, ...) on arrays reached through a snapshot/table field.
RI004  no module-scope import of torch (or a module that pulls torch in)
       from a host-only module; ``if TYPE_CHECKING:`` blocks are exempt.
RI005  no lock acquisition and no heap-allocating logging/diagnostics in
       functions marked ``@hot_path``.
RI006  no internal calls to the deprecated ``stats()`` / ``service_stats()``
       / ``pipeline_stats()`` dict surfaces -- use ``metrics()``.
RI007  every lock attribute is acquired consistently with the declared
       global order (``contracts.LOCK_ORDER``); any cycle in the observed
       static acquisition graph is an error.

Usage::

    from repro_torch.analysis.invariants import Analyzer, check_source
    violations = check_source(src_text, "repro_torch/index/table.py")
    # or over a tree:
    analyzer = Analyzer()
    analyzer.check_paths(["src/"])
    for v in analyzer.violations:
        print(v)
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from . import contracts

RULES = {
    "RI001": "attribute mutation of a frozen-contract instance",
    "RI002": "double-deref of a swap-on-publish handle field",
    "RI003": "in-place numpy mutation of a published array",
    "RI004": "accelerator import at module scope in a host-only module",
    "RI005": "lock acquisition or logging inside a @hot_path function",
    "RI006": "internal call to a deprecated stats() dict surface",
    "RI007": "lock acquisition order inconsistent with the declared order",
}

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_,\s]+)\]")
_LOCK_NAME_RE = re.compile(r"lock", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _allow_map(source: str) -> dict[int, set[str]]:
    """line number -> set of rule codes suppressed on that line."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = {c.strip().upper() for c in m.group(1).split(",")
                      if c.strip()}
    return out


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _module_package(path: str) -> list[str]:
    """Dotted package path of the *directory* holding ``path`` (best effort:
    anchored at the last ``repro_torch`` component; fixtures without one get
    [])."""
    parts = _norm(path).split("/")[:-1]
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "repro_torch":
            return parts[i:]
    return []


def _attr_root(node: ast.AST) -> str | None:
    """Leftmost ``Name`` of a (possibly dotted) expression, if any."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _ann_class(ann: ast.AST | None) -> str | None:
    """Class name out of a simple annotation (``T``, ``"T"``, ``m.T``)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].strip()
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


def _is_pinned_field(attr: str) -> bool:
    return (attr in contracts.PINNED_FIELDS
            or attr.endswith(contracts.PINNED_SUFFIXES))


class _FunctionChecker(ast.NodeVisitor):
    """Per-function pass: RI001/RI002/RI003/RI005/RI006 + RI007 edges."""

    def __init__(self, owner: "_FileChecker", func: ast.AST,
                 class_name: str | None):
        self.owner = owner
        self.func = func
        self.class_name = class_name
        self.qualname = (f"{class_name}.{func.name}" if class_name
                         else func.name)
        self.hot = any(
            (isinstance(d, ast.Name) and d.id == "hot_path")
            or (isinstance(d, ast.Attribute) and d.attr == "hot_path")
            for d in func.decorator_list)
        # RI001: locals inferred to hold frozen-contract instances
        self.frozen_vars: dict[str, str] = {}
        for arg in [*func.args.posonlyargs, *func.args.args,
                    *func.args.kwonlyargs]:
            cls = _ann_class(arg.annotation)
            if cls in contracts.FROZEN_CLASSES:
                self.frozen_vars[arg.arg] = cls
        if class_name in contracts.FROZEN_CLASSES:
            self.frozen_vars["self"] = class_name
        self.in_frozen_init = (class_name in contracts.FROZEN_CLASSES
                               and func.name in ("__init__", "__post_init__"))
        # RI002: (base expr, field) -> first-read line
        self.pin_reads: dict[tuple[str, str], int] = {}
        # RI003: local aliases of published arrays -> source expr
        self.aliases: dict[str, str] = {}
        # RI007: innermost-last stack of lock names held syntactically
        self.lock_stack: list[str] = []

    def report(self, rule: str, node: ast.AST, message: str) -> None:
        self.owner.report(rule, node, message)

    # -- helpers -----------------------------------------------------------
    def _frozen_class_of(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Name):
            return self.frozen_vars.get(expr.id)
        return None

    def _protected(self, expr: ast.AST) -> str | None:
        """Published-array expression? (``<base>.keys`` or an alias of one)"""
        if (isinstance(expr, ast.Attribute)
                and expr.attr in contracts.FROZEN_ARRAY_FIELDS):
            return ast.unparse(expr)
        if isinstance(expr, ast.Name) and expr.id in self.aliases:
            return self.aliases[expr.id]
        return None

    def _check_store_target(self, target: ast.AST, node: ast.AST,
                            augmented: bool = False) -> None:
        """RI001 (frozen attr store) + RI003 (subscript store) on one
        assignment target."""
        if isinstance(target, ast.Attribute):
            cls = self._frozen_class_of(target.value)
            if cls is not None and not self.in_frozen_init:
                self.report("RI001", node,
                            f"assignment to {ast.unparse(target)} mutates "
                            f"frozen {cls} (build a new instance instead)")
            if augmented and self._protected(target):
                self.report("RI003", node,
                            f"in-place update of published array "
                            f"{ast.unparse(target)}")
        elif isinstance(target, ast.Subscript):
            src = self._protected(target.value)
            if src is not None:
                self.report("RI003", node,
                            f"in-place write through published array {src}")
        elif isinstance(target, ast.Name):
            # `k += 1` through an alias is in-place on the published array
            # (plain `k = ...` merely rebinds the name and is fine)
            if augmented and target.id in self.aliases:
                self.report("RI003", node,
                            f"in-place update of published array "
                            f"{self.aliases[target.id]} via alias "
                            f"{target.id}")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store_target(elt, node, augmented)

    # -- statements --------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store_target(t, node)
        # track frozen-constructor locals and published-array aliases
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            self.frozen_vars.pop(name, None)
            self.aliases.pop(name, None)
            v = node.value
            if isinstance(v, ast.Call):
                cls = None
                if isinstance(v.func, ast.Name):
                    cls = v.func.id
                elif isinstance(v.func, ast.Attribute):
                    cls = v.func.attr
                if cls in contracts.FROZEN_CLASSES:
                    self.frozen_vars[name] = cls
            else:
                src = self._protected(v)
                if src is not None:
                    self.aliases[name] = src
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_store_target(node.target, node)
        if isinstance(node.target, ast.Name):
            cls = _ann_class(node.annotation)
            if cls in contracts.FROZEN_CLASSES:
                self.frozen_vars[node.target.id] = cls
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_target(node.target, node, augmented=True)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Attribute):
                cls = self._frozen_class_of(t.value)
                if cls is not None:
                    self.report("RI001", node,
                                f"del {ast.unparse(t)} mutates frozen {cls}")
            elif isinstance(t, ast.Subscript):
                src = self._protected(t.value)
                if src is not None:
                    self.report("RI003", node,
                                f"in-place delete through published array "
                                f"{src}")
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node: ast.With | ast.AsyncWith) -> None:
        acquired: list[str] = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is None:
                continue
            if self.hot:
                self.report("RI005", node,
                            f"@hot_path {self.qualname} acquires lock "
                            f"{name}")
            for held in self.lock_stack + acquired:
                if held != name:
                    self.owner.lock_edge(held, name, node)
            acquired.append(name)
            for expr in (item.context_expr,):
                self.visit(expr)  # still scan the expr itself
        self.lock_stack.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        del self.lock_stack[len(self.lock_stack) - len(acquired):]

    def _lock_name(self, expr: ast.AST) -> str | None:
        """Canonical lock identity for a with-context expression, or None."""
        target = expr
        if isinstance(target, ast.Call):  # e.g. threading.Lock() inline
            target = target.func
        if isinstance(target, ast.Attribute):
            if not _LOCK_NAME_RE.search(target.attr):
                return None
            root = _attr_root(target)
            if root in ("self", "cls") and self.class_name:
                return f"{self.class_name}.{target.attr}"
            return f"{root}.{target.attr}" if root else target.attr
        if isinstance(target, ast.Name) and _LOCK_NAME_RE.search(target.id):
            return target.id
        return None

    # -- expressions -------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load) and _is_pinned_field(node.attr):
            key = (ast.unparse(node.value), node.attr)
            first = self.pin_reads.get(key)
            if first is None:
                self.pin_reads[key] = node.lineno
            else:
                self.report(
                    "RI002", node,
                    f"{key[0]}.{node.attr} dereferenced again in "
                    f"{self.qualname} (first read at line {first}); bind a "
                    f"pinned local once and reuse it")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # RI001: object.__setattr__ outside the setattr allowlist
        if (isinstance(func, ast.Attribute) and func.attr == "__setattr__"
                and isinstance(func.value, ast.Name)
                and func.value.id == "object"):
            # a frozen class initialising *itself* is construction, not
            # mutation: object.__setattr__(self, ...) in __init__/__post_init__
            self_init = (
                self.func.name in ("__init__", "__post_init__", "__new__")
                and bool(node.args)
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in ("self", "cls"))
            if not self_init and not self.owner.setattr_allowed(self.qualname):
                self.report("RI001", node,
                            f"object.__setattr__ outside the builder "
                            f"allowlist (in {self.qualname})")
        if isinstance(func, ast.Attribute):
            # RI003: in-place ndarray methods on published arrays
            if func.attr in contracts.INPLACE_NDARRAY_METHODS:
                src = self._protected(func.value)
                if src is None and ast.unparse(func.value) == "np.ndarray":
                    src = (self._protected(node.args[0])
                           if node.args else None)
                if src is not None:
                    self.report("RI003", node,
                                f"in-place {func.attr}() on published "
                                f"array {src}")
            if func.attr == "copyto" and node.args:
                src = self._protected(node.args[0])
                if src is not None:
                    self.report("RI003", node,
                                f"np.copyto into published array {src}")
            # RI006: deprecated dict surfaces
            if func.attr in contracts.DEPRECATED_CALLS:
                self.report("RI006", node,
                            f".{func.attr}() is deprecated inside the repo; "
                            f"use the typed metrics() tree")
            # RI005: explicit acquire in a hot path
            if self.hot and func.attr == "acquire":
                self.report("RI005", node,
                            f"@hot_path {self.qualname} calls .acquire()")
        if self.hot:
            root = _attr_root(func)
            if root in contracts.HOT_PATH_FORBIDDEN_CALLS:
                self.report("RI005", node,
                            f"@hot_path {self.qualname} calls {root} "
                            f"(heap-allocating diagnostic)")
            elif root == "threading":
                self.report("RI005", node,
                            f"@hot_path {self.qualname} constructs a "
                            f"threading primitive")
        self.generic_visit(node)

    # nested defs get their own checker; don't descend with this one's state
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is not self.func:
            self.owner.check_function(node, self.class_name)
        else:
            self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self.visit_FunctionDef(node)  # type: ignore[arg-type]

    def run(self) -> None:
        for stmt in self.func.body:
            self.visit(stmt)


class _FileChecker:
    def __init__(self, analyzer: "Analyzer", path: str, source: str,
                 tree: ast.Module):
        self.analyzer = analyzer
        self.path = _norm(path)
        self.tree = tree
        self.allow = _allow_map(source)
        self.violations: list[Violation] = []

    def report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.allow.get(line, ()):  # suppressed in source
            return
        self.violations.append(Violation(rule, self.path, line, message))

    def setattr_allowed(self, qualname: str) -> bool:
        return any(self.path.endswith(suffix) and qualname == q
                   for suffix, q in contracts.FROZEN_SETATTR_ALLOW)

    def lock_edge(self, outer: str, inner: str, node: ast.AST) -> None:
        if (outer in contracts.LOCK_RANK and inner in contracts.LOCK_RANK
                and contracts.LOCK_RANK[outer] > contracts.LOCK_RANK[inner]):
            self.report("RI007", node,
                        f"acquires {inner} while holding {outer}, against "
                        f"the declared order in contracts.LOCK_ORDER")
        self.analyzer.lock_edges.setdefault(
            (outer, inner), (self.path, getattr(node, "lineno", 0)))

    # -- traversal ---------------------------------------------------------
    def check(self) -> list[Violation]:
        self._check_module_imports()
        self._walk_body(self.tree.body, class_name=None)
        return self.violations

    def _walk_body(self, body: list[ast.stmt],
                   class_name: str | None) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.check_function(stmt, class_name)
            elif isinstance(stmt, ast.ClassDef):
                self._walk_body(stmt.body, class_name=stmt.name)
            elif isinstance(stmt, (ast.If, ast.Try, ast.With)):
                inner = [*getattr(stmt, "body", [])]
                for attr in ("orelse", "finalbody"):
                    inner.extend(getattr(stmt, attr, []))
                for h in getattr(stmt, "handlers", []):
                    inner.extend(h.body)
                self._walk_body(inner, class_name)

    def check_function(self, func: ast.AST, class_name: str | None) -> None:
        _FunctionChecker(self, func, class_name).run()

    # -- RI004 -------------------------------------------------------------
    def _check_module_imports(self) -> None:
        if not any(self.path.endswith(m) for m in contracts.HOST_ONLY_MODULES):
            return
        pkg = _module_package(self.path)
        for stmt in self._module_scope_stmts(self.tree.body):
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    self._check_import_name(alias.name, stmt)
            elif isinstance(stmt, ast.ImportFrom):
                name = self._resolve_from(stmt, pkg)
                if name:
                    self._check_import_name(name, stmt)

    def _module_scope_stmts(self, body: list[ast.stmt]):
        """Module-level statements, descending into plain if/try blocks but
        not into ``if TYPE_CHECKING:`` guards (annotation-only imports)."""
        for stmt in body:
            if isinstance(stmt, ast.If):
                test = ast.unparse(stmt.test)
                if "TYPE_CHECKING" in test:
                    yield from self._module_scope_stmts(stmt.orelse)
                    continue
                yield from self._module_scope_stmts(stmt.body)
                yield from self._module_scope_stmts(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                inner = [*stmt.body, *stmt.orelse, *stmt.finalbody]
                for h in stmt.handlers:
                    inner.extend(h.body)
                yield from self._module_scope_stmts(inner)
            else:
                yield stmt

    def _resolve_from(self, stmt: ast.ImportFrom,
                      pkg: list[str]) -> str | None:
        if stmt.level == 0:
            return stmt.module
        if not pkg:
            return stmt.module  # fixture without an anchor: best effort
        base = pkg[: len(pkg) - (stmt.level - 1)]
        return ".".join([*base, stmt.module] if stmt.module else base)

    def _check_import_name(self, name: str, stmt: ast.stmt) -> None:
        for root in contracts.ACCEL_IMPORT_ROOTS:
            if name == root or name.startswith(root + "."):
                self.report(
                    "RI004", stmt,
                    f"host-only module imports {name} at module scope "
                    f"(pulls in the accelerator stack); import lazily "
                    f"inside the function that needs it")
                return


class Analyzer:
    """Whole-run pass: per-file rules plus the global RI007 lock graph."""

    def __init__(self) -> None:
        self.violations: list[Violation] = []
        self.errors: list[str] = []  # unparsable files
        # (outer, inner) -> first (path, line) observed
        self.lock_edges: dict[tuple[str, str], tuple[str, int]] = {}

    def check_source(self, source: str, path: str) -> list[Violation]:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            self.errors.append(f"{path}: syntax error: {exc}")
            return []
        found = _FileChecker(self, path, source, tree).check()
        self.violations.extend(found)
        return found

    def check_paths(self, paths: list[str]) -> None:
        for path in paths:
            p = Path(path)
            files = (sorted(p.rglob("*.py")) if p.is_dir() else [p])
            for f in files:
                if "__pycache__" in f.parts:
                    continue
                self.check_source(f.read_text(encoding="utf-8"), str(f))

    def finish(self) -> list[Violation]:
        """Run-level checks (RI007 cycle detection).  Call once, at the end."""
        cycle = _find_cycle({a: {b for (x, b) in self.lock_edges if x == a}
                             for (a, _b) in self.lock_edges})
        if cycle:
            path, line = self.lock_edges[(cycle[0], cycle[1])]
            self.violations.append(Violation(
                "RI007", path, line,
                "lock-order cycle in the static acquisition graph: "
                + " -> ".join([*cycle, cycle[0]])))
        return self.violations


def _find_cycle(graph: dict[str, set[str]]) -> list[str] | None:
    state: dict[str, int] = {}  # 1 = on stack, 2 = done
    stack: list[str] = []

    def dfs(n: str) -> list[str] | None:
        state[n] = 1
        stack.append(n)
        for m in graph.get(n, ()):
            if state.get(m) == 1:
                return stack[stack.index(m):]
            if state.get(m, 0) == 0:
                found = dfs(m)
                if found:
                    return found
        stack.pop()
        state[n] = 2
        return None

    for node in list(graph):
        if state.get(node, 0) == 0:
            found = dfs(node)
            if found:
                return found
    return None


def check_source(source: str, path: str = "<fixture>.py") -> list[Violation]:
    """One-shot convenience for tests: per-file rules + RI007 finish pass."""
    analyzer = Analyzer()
    analyzer.check_source(source, path)
    return analyzer.finish()
