"""R4 — backend conformance.

Invariant: the port's :class:`Backend` hook set
(``repro_torch/core/contraction.py``) is the engine's hardware ABI:
every subclass defines each hook the base leaves raising
``NotImplementedError`` (a subclass that forgets ``gather_dist_rows``
inherits the raise and breaks only on the row-sparse frontier path), and
every *string* backend reference resolves against ``KNOWN_BACKENDS``. The
motivating bug is the JAX package's ``"palas"`` typo: a misspelled
backend name silently fell back to the oracle, and the benchmarks
measured the wrong engine. The port's ``resolve_backend`` raises on an
unknown name, but only when that line runs.

Flagged, project-wide:

* a class whose bases include ``Backend`` for which any hook of
  ``contract`` / ``contract_rows`` / ``contract_batched`` /
  ``contract_rows_ell`` / ``_contract_ell`` / ``gather_dist_rows`` /
  ``prepare_state`` / ``decode_state`` / ``zero`` / ``exact`` fails to
  resolve concretely: hooks the base leaves abstract (body raises
  ``NotImplementedError``) must be defined in the subclass; hooks with a
  concrete base default (the identity representation, the generic
  gather) may be inherited
* a string literal backend reference (``backend="..."`` keyword or
  default, or the first argument of ``resolve_backend``) not in
  ``KNOWN_BACKENDS``, read from ``core/contraction.py``'s AST when
  present so the rule tracks the real registry
"""
from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from ..analyzer import Finding, Project, dotted

RULE = "R4"
TITLE = "backend conformance (hook set, KNOWN_BACKENDS resolution)"

BASE_CLASS = "Backend"
REQUIRED_HOOKS = ("contract", "contract_rows", "contract_batched",
                  "contract_rows_ell", "_contract_ell", "gather_dist_rows",
                  "prepare_state", "decode_state", "zero", "exact")
_REGISTRY = "core/contraction.py"
_FALLBACK_KNOWN = ("cuda", "plain", "mxu_bucket")


def _known_backends(project: Project) -> Tuple[str, ...]:
    mod = project.by_suffix(_REGISTRY)
    if mod is None:
        return _FALLBACK_KNOWN
    for n in mod.tree.body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == "KNOWN_BACKENDS":
                    if isinstance(n.value, (ast.Tuple, ast.List)):
                        vals = tuple(
                            e.value for e in n.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
                        if vals:
                            return vals
    return _FALLBACK_KNOWN


def _class_defines(cls: ast.ClassDef) -> Set[str]:
    names: Set[str] = set()
    for n in cls.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _raises_not_implemented(fn: ast.AST) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Raise) and n.exc is not None:
            exc = n.exc.func if isinstance(n.exc, ast.Call) else n.exc
            if dotted(exc).rsplit(".", 1)[-1] == "NotImplementedError":
                return True
    return False


def _base_class(project: Project):
    """The hook set's base class: the registry module's, else any class
    of that name (rule fixtures); None if there is none."""
    mods = [project.by_suffix(_REGISTRY)] + list(project)
    for mod in mods:
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == BASE_CLASS:
                return node
    return None


def _abstract_hooks(project: Project) -> Set[str]:
    """Hooks the base class leaves abstract: a subclass MUST define these;
    the rest have concrete base defaults and may be inherited. With no
    base class in scope, the full set is required."""
    base = _base_class(project)
    if base is None:
        return set(REQUIRED_HOOKS)
    concrete: Set[str] = set()
    for n in base.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if n.name in REQUIRED_HOOKS and not _raises_not_implemented(n):
                concrete.add(n.name)
        elif isinstance(n, ast.Assign):
            concrete.update(t.id for t in n.targets
                            if isinstance(t, ast.Name) and t.id in REQUIRED_HOOKS)
        elif (isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
              and n.target.id in REQUIRED_HOOKS and n.value is not None):
            concrete.add(n.target.id)
    return set(REQUIRED_HOOKS) - concrete


def _bad_name(node: ast.AST, known) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value not in known)


def check(project: Project) -> Iterator[Finding]:
    known = _known_backends(project)
    must_define = _abstract_hooks(project)
    for mod in project:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                if not any(dotted(b).rsplit(".", 1)[-1] == BASE_CLASS
                           for b in node.bases):
                    continue
                missing = [h for h in REQUIRED_HOOKS
                           if h in must_define and h not in _class_defines(node)]
                if missing:
                    yield Finding(
                        RULE, mod.relpath, node.lineno, node.col_offset,
                        f"backend `{node.name}` missing hook(s) "
                        f"{', '.join(missing)}: every abstract {BASE_CLASS} "
                        "hook must be defined")
            elif isinstance(node, ast.Call):
                callee = dotted(node.func).rsplit(".", 1)[-1]
                if (callee == "resolve_backend" and node.args
                        and _bad_name(node.args[0], known)):
                    yield Finding(
                        RULE, mod.relpath, node.args[0].lineno,
                        node.args[0].col_offset,
                        f"backend name '{node.args[0].value}' not in "
                        f"KNOWN_BACKENDS {known}")
                for kw in node.keywords:
                    if kw.arg == "backend" and _bad_name(kw.value, known):
                        yield Finding(
                            RULE, mod.relpath, kw.value.lineno,
                            kw.value.col_offset,
                            f"backend name '{kw.value.value}' not in "
                            f"KNOWN_BACKENDS {known}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                pairs = list(zip(reversed(args.args), reversed(args.defaults)))
                pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                          if d is not None]
                for arg, default in pairs:
                    if arg.arg == "backend" and _bad_name(default, known):
                        yield Finding(
                            RULE, mod.relpath, default.lineno,
                            default.col_offset,
                            f"default backend '{default.value}' not in "
                            f"KNOWN_BACKENDS {known}")
