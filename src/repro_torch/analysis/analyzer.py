"""The rule-engine core: module loading, noqa suppression, the dispatch
call graph, and shared AST predicates.

Everything here is plain ``ast``: no torch, jax or ``repro`` import, so
the analyzer runs on a bare interpreter.

Model
-----
``load_project(paths)`` parses every ``*.py`` under the given paths into
:class:`Module` objects (source + AST + per-line noqa directives) and
wraps them in a :class:`Project`. Rules (see ``rules/``) are modules with
``RULE``/``TITLE`` constants and a ``check(project)`` generator yielding
:class:`Finding`; :func:`run` applies the suppression directives and
returns the findings plus the file count.

Suppressions: ``# repro: noqa[R1]`` (or ``noqa[R1,R5]``) on the flagged
line suppresses those rules there; a bare ``# repro: noqa`` suppresses
every rule on the line. The reason goes on the same line, after the
directive. Suppressed findings are still reported (marked), so each
justification stays reviewable, but they don't fail the gate.

The dispatch call graph (:class:`CallGraph`) is what scopes rule R1. The
port has no ``jit`` to root it, so its roots are given: the table
``DISPATCH_ROOTS`` in ``rules/r1_dispatch_syncs.py`` names the port's
counterpart of each traced entry point of the JAX package. Reachability
follows same-module calls, cross-module ``from X import f`` calls, and
function-reference arguments (``_frontier_loop(state, step, ...)``).
Attribute calls (``backend.contract_rows``, ``self._flush_counts``) are
not resolved: method dispatch is out of scope, and a method that must be
checked is listed as a root by its ``Class.method`` qualname.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_,\s]+)\])?")

# scopes that stop a region scan: nodes inside them belong to the nested
# scope, not the one being scanned (lambdas stay inline: they run in the
# enclosing scope)
_SCOPE_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _dotted_name(relpath: str) -> str:
    """'src/repro_torch/core/executor.py' -> 'repro_torch.core.executor'
    (what the import resolver keys on). Fixture files without the src/
    prefix keep their path-derived name."""
    p = relpath.replace(os.sep, "/").lstrip("./")
    if "/src/" in p:
        p = p.split("/src/", 1)[1]
    elif p.startswith("src/"):
        p = p[len("src/"):]
    if p.endswith(".py"):
        p = p[: -len(".py")]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Module:
    """One parsed source file: AST, raw lines, noqa directives, and the
    function/import indexes the call graph and rules share."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.dotted = _dotted_name(self.relpath)
        # line -> suppressed rule ids; empty set means "all rules"
        self.noqa: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(line)
            if m:
                codes = m.group(1)
                self.noqa[i] = (
                    {c.strip().upper() for c in codes.split(",") if c.strip()}
                    if codes else set())
        self.funcs: Dict[str, ast.AST] = {}
        self._index_functions()
        self.imports: Dict[str, Tuple[str, str]] = {}
        self._index_imports()

    # -- indexes ------------------------------------------------------------

    def _index_functions(self) -> None:
        def rec(scope: ast.AST, qual: str) -> None:
            for n in scan_region(scope):
                if isinstance(n, _SCOPE_TYPES):
                    q = f"{qual}.{n.name}" if qual else n.name
                    if not isinstance(n, ast.ClassDef):
                        self.funcs[q] = n
                    rec(n, q)

        rec(self.tree, "")

    def _index_imports(self) -> None:
        pkg = self.dotted.rsplit(".", 1)[0] if "." in self.dotted else ""
        for n in ast.walk(self.tree):
            if not isinstance(n, ast.ImportFrom):
                continue
            if n.level:
                base = pkg.split(".") if pkg else []
                base = base[: len(base) - (n.level - 1)] if n.level > 1 else base
                target = ".".join(base + (n.module.split(".") if n.module else []))
            else:
                target = n.module or ""
            for alias in n.names:
                self.imports[alias.asname or alias.name] = (target, alias.name)

    # -- suppression --------------------------------------------------------

    def is_suppressed(self, line: int, rule: str) -> bool:
        codes = self.noqa.get(line)
        if codes is None:
            return False
        return not codes or rule.upper() in codes


FuncKey = Tuple[str, str]  # (module dotted name, function qualname)


class Project:
    def __init__(self, modules: Sequence[Module]):
        self.modules: Dict[str, Module] = {m.dotted: m for m in modules}
        self.by_path: Dict[str, Module] = {m.relpath: m for m in modules}

    def __iter__(self) -> Iterator[Module]:
        return iter(self.modules.values())

    def by_suffix(self, suffix: str) -> Optional[Module]:
        for m in self.modules.values():
            if m.relpath.endswith(suffix):
                return m
        return None

    def has_function(self, key: FuncKey) -> bool:
        mod = self.modules.get(key[0])
        return mod is not None and key[1] in mod.funcs

    def callgraph(self, roots: Iterable[FuncKey]) -> "CallGraph":
        """The call graph reachable from ``roots`` (those of them the
        project defines)."""
        return CallGraph(self, [r for r in roots if self.has_function(r)])


# -- AST helpers shared by the rules ----------------------------------------


def scan_region(node: ast.AST) -> Iterator[ast.AST]:
    """Yield every node in ``node``'s own scope, without descending into
    nested function/class definitions (the defs themselves ARE yielded;
    lambdas are descended: they run inline)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _SCOPE_TYPES):
            stack.extend(ast.iter_child_nodes(n))


def dotted(node: ast.AST) -> str:
    """'torch.nonzero' for Attribute(Name('torch'), 'nonzero'); '' if
    unresolvable."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_STATIC_ATTRS = ("shape", "ndim", "size", "dtype", "itemsize", "device",
                 "is_cuda")
#: tensor methods that read host metadata, never the device
_STATIC_METHODS = ("numel", "dim", "size", "element_size", "nelement",
                   "ndimension", "is_contiguous", "data_ptr")


def is_static_expr(node: ast.AST) -> bool:
    """Conservatively true when the expression is host metadata (shape,
    ndim, numel and len arithmetic, constants): casting it to a Python
    scalar reads nothing from the device and is flagged by no rule."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return is_static_expr(node.value)
    if isinstance(node, ast.UnaryOp):
        return is_static_expr(node.operand)
    if isinstance(node, ast.BinOp):
        return is_static_expr(node.left) and is_static_expr(node.right)
    if isinstance(node, ast.Call):
        f = dotted(node.func)
        if f == "len":
            return True
        if f in ("int", "float", "bool", "min", "max", "abs"):
            return all(is_static_expr(a) for a in node.args)
        if f in ("np.prod", "math.prod", "numpy.prod"):
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATIC_METHODS):
            return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(is_static_expr(e) for e in node.elts)
    return False


# -- the dispatch call graph -------------------------------------------------


class CallGraph:
    """Reachability from the given dispatch roots, project-wide."""

    def __init__(self, project: Project, roots: Iterable[FuncKey]):
        self.project = project
        self.roots: Set[FuncKey] = set(roots)
        self.edges: Dict[FuncKey, Set[FuncKey]] = {}
        for mod in project:
            self._scan_module(mod)
        self.reachable: Set[FuncKey] = self._bfs()

    def _resolve(self, mod: Module, qual: str, name: str) -> Optional[FuncKey]:
        parts = qual.split(".") if qual else []
        for i in range(len(parts), -1, -1):
            cand = ".".join(parts[:i] + [name])
            if cand in mod.funcs:
                return (mod.dotted, cand)
        imp = mod.imports.get(name)
        if imp is not None:
            tmod = self.project.modules.get(imp[0])
            if tmod is not None and imp[1] in tmod.funcs:
                return (tmod.dotted, imp[1])
        return None

    def _scan_scope(self, mod: Module, qual: str, scope: ast.AST) -> None:
        key = (mod.dotted, qual)
        out = self.edges.setdefault(key, set())
        for n in scan_region(scope):
            if not isinstance(n, ast.Call):
                continue
            callee = dotted(n.func)
            if callee and "." not in callee:
                tgt = self._resolve(mod, qual, callee)
                if tgt is not None:
                    out.add(tgt)
            # function-reference arguments (a loop's step function, a
            # callback): reachability flows through them
            for arg in list(n.args) + [kw.value for kw in n.keywords]:
                if isinstance(arg, ast.Name):
                    tgt = self._resolve(mod, qual, arg.id)
                    if tgt is not None:
                        out.add(tgt)

    def _scan_module(self, mod: Module) -> None:
        self._scan_scope(mod, "", mod.tree)
        for qual, node in mod.funcs.items():
            self._scan_scope(mod, qual, node)

    def _bfs(self) -> Set[FuncKey]:
        seen: Set[FuncKey] = set()
        frontier = list(self.roots)
        while frontier:
            key = frontier.pop()
            if key in seen:
                continue
            seen.add(key)
            for nxt in self.edges.get(key, ()):
                if nxt not in seen:
                    frontier.append(nxt)
        return seen

    def reachable_functions(self) -> Iterator[Tuple[Module, str, ast.AST]]:
        for mod_name, qual in sorted(self.reachable):
            mod = self.project.modules.get(mod_name)
            if mod is not None and qual in mod.funcs:
                yield mod, qual, mod.funcs[qual]


# -- driving ----------------------------------------------------------------


def load_project(paths: Sequence[str], root: Optional[str] = None) -> Project:
    """Parse every ``*.py`` under ``paths`` (files or directories) into a
    Project. ``root`` anchors the reported relative paths (default: the
    paths as given, normalized)."""
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(
                    os.path.join(dirpath, f) for f in filenames
                    if f.endswith(".py"))
    modules = []
    for f in sorted(set(files)):
        rel = os.path.relpath(f, root) if root else os.path.normpath(f)
        with open(f, "r", encoding="utf-8") as fh:
            modules.append(Module(rel, fh.read()))
    return Project(modules)


def analyze_sources(sources: Dict[str, str],
                    rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the rules over in-memory {relpath: source}: the fixture-test
    entry point."""
    project = Project([Module(rp, src) for rp, src in sources.items()])
    return run_project(project, rules)


def run(paths: Sequence[str],
        rules: Optional[Sequence[str]] = None) -> Tuple[List[Finding], int]:
    project = load_project(paths)
    return run_project(project, rules), len(project.modules)


def run_project(project: Project,
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Every wanted rule's findings over ``project``, suppressions applied,
    sorted by place."""
    from .rules import ALL_RULES

    wanted = {r.upper() for r in rules} if rules else None
    findings: List[Finding] = []
    for rule_mod in ALL_RULES:
        if wanted is not None and rule_mod.RULE.upper() not in wanted:
            continue
        for f in rule_mod.check(project):
            mod = project.by_path.get(f.path)
            if mod is not None and mod.is_suppressed(f.line, f.rule):
                f = dataclasses.replace(f, suppressed=True)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def format_text(findings: Iterable[Finding], n_files: int) -> str:
    findings = list(findings)
    live = [f for f in findings if not f.suppressed]
    lines = [f.format() for f in findings]
    lines.append(
        f"{len(live)} finding(s) ({len(findings) - len(live)} suppressed) "
        f"in {n_files} file(s)")
    return "\n".join(lines)


def format_json(findings: Iterable[Finding], n_files: int) -> str:
    findings = list(findings)
    live = [f for f in findings if not f.suppressed]
    counts: Dict[str, int] = {}
    for f in live:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps(
        {
            "findings": [f.to_json() for f in findings],
            "unsuppressed": len(live),
            "suppressed": len(findings) - len(live),
            "counts_by_rule": counts,
            "checked_files": n_files,
        },
        indent=1, sort_keys=True)
