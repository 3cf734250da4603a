"""R2 — recompile hazards, restated for the port: capacity bucketing.

Invariant: every capacity that sets a state shape (``f_cap``,
``frontier_cap``, ``q_cap``, ``n_slots``, Q/K pads, the ELL degree and
spill-ring caps ``ell_cap``/``spill_cap``, the row-sparse dist slot and
overflow caps ``dist_cap``/``ovf_cap``) is bucketed: pow2 growth via
``_next_pow2``, multiple round-up via ``_round_up``, or x2 doubling of an
already-bucketed value. The port compiles nothing per shape, but it
keeps the JAX package's capacities step for step: the port's state
shapes equal the reference's after every dispatch, and the leaf-for-leaf
identity tests and the byte-compatible checkpoints (a checkpoint of
either package restores in the other) depend on that. Raw capacity
arithmetic (``n + (-n) % k`` inline, literal non-pow2 caps) makes the two
packages' shapes part ways at the first growth.

Second hazard class: unhashable arguments reaching an ``lru_cache``-
wrapped factory: a list/dict/set literal in such a call raises
``TypeError: unhashable`` only at runtime, on the rarely-hit cache path.

Flagged (the same forms and messages as the JAX package's R2):

* assignment to a capacity-named target whose RHS does raw arithmetic or
  a non-power-of-two int literal without routing through a bucketing
  helper (``_next_pow2`` / ``_round_up``), doubling (``cap * 2``,
  ``cap <<= 1``), a ``.shape`` mirror, or a plain alias of an
  already-bucketed name
* calls to an ``lru_cache``-decorated function (same module or imported)
  with a list/dict/set literal or comprehension argument
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Set, Tuple

from ..analyzer import Finding, Module, Project, dotted

RULE = "R2"
TITLE = "recompile hazards (un-bucketed capacities, unhashable cache keys)"

_CAP_RE = re.compile(
    r"(?:^|_)(f_cap|frontier_cap|q_cap|k_cap|n_cap|n_slots|q_pad|k_pad"
    r"|ell_cap|spill_cap|dist_cap|ovf_cap)$")
_BUCKET_HELPERS = {
    "_next_pow2", "next_pow2", "_round_up", "round_up", "pick_block_sizes",
}
_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp)


def _target_cap_name(target: ast.AST) -> str:
    name = ""
    if isinstance(target, ast.Name):
        name = target.id
    elif isinstance(target, ast.Attribute):
        name = target.attr
    m = _CAP_RE.search(name.lstrip("_"))
    return name if m else ""


def _is_pow2(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and (
        v in (0, 1) or (v > 0 and (v & (v - 1)) == 0))


def _rhs_is_bucketed(node: ast.AST, cap_name: str) -> bool:
    """True when the value expression provably rides the bucketing
    discipline (helper call / doubling / shape mirror / alias)."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        # alias of an existing (already bucketed) value; .shape mirrors
        return True
    if isinstance(node, ast.Constant):
        # None is the "unset, sized later" sentinel (e.g. dist_ovf_cap
        # before first placement), not a capacity value
        return node.value is None or _is_pow2(node.value)
    if isinstance(node, ast.Call):
        f = dotted(node.func).rsplit(".", 1)[-1]
        if f in _BUCKET_HELPERS:
            return True
        if f in ("int", "float", "min", "max"):
            return all(_rhs_is_bucketed(a, cap_name) for a in node.args)
        return False
    if isinstance(node, ast.IfExp):
        return (_rhs_is_bucketed(node.body, cap_name)
                and _rhs_is_bucketed(node.orelse, cap_name))
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Mult):
            for a, b in ((node.left, node.right), (node.right, node.left)):
                if (isinstance(a, ast.Constant) and a.value == 2
                        and _rhs_is_bucketed(b, cap_name)):
                    return True
        if (isinstance(node.op, ast.LShift)
                and isinstance(node.right, ast.Constant)):
            return _rhs_is_bucketed(node.left, cap_name)
        return False
    if isinstance(node, ast.Subscript):
        return _rhs_is_bucketed(node.value, cap_name)
    return False


def _lru_cached_names(mod: Module) -> Set[str]:
    out: Set[str] = set()
    for qual, fn in mod.funcs.items():
        decs = getattr(fn, "decorator_list", [])
        for d in decs:
            for n in ast.walk(d):
                if (isinstance(n, ast.Attribute) and n.attr in
                        ("lru_cache", "cache")) or (
                        isinstance(n, ast.Name) and n.id in
                        ("lru_cache", "cache")):
                    out.add(qual.rsplit(".", 1)[-1])
    return out


def check(project: Project) -> Iterator[Finding]:
    cached_by_mod = {m.dotted: _lru_cached_names(m) for m in project}
    for mod in project:
        for node in ast.walk(mod.tree):
            # -- capacity assignments --------------------------------------
            targets: Tuple[ast.AST, ...] = ()
            value = None
            if isinstance(node, ast.Assign):
                targets, value = tuple(node.targets), node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = (node.target,), node.value
            elif isinstance(node, ast.AugAssign):
                # cap *= 2 / cap <<= 1 are the sanctioned growth steps
                if _target_cap_name(node.target) and not (
                        (isinstance(node.op, ast.Mult)
                         and isinstance(node.value, ast.Constant)
                         and node.value.value == 2)
                        or isinstance(node.op, ast.LShift)):
                    yield Finding(
                        RULE, mod.relpath, node.lineno, node.col_offset,
                        f"augmented capacity update to "
                        f"`{_target_cap_name(node.target)}` is not a x2 "
                        "doubling — route through _next_pow2/_round_up")
                continue
            for t in targets:
                cap = _target_cap_name(t)
                if cap and value is not None and not _rhs_is_bucketed(
                        value, cap):
                    yield Finding(
                        RULE, mod.relpath, node.lineno, node.col_offset,
                        f"capacity `{cap}` assigned from raw arithmetic/"
                        "literal — route through _next_pow2/_round_up so "
                        "the jit compile cache stays shared")
            # -- unhashable lru_cache arguments ----------------------------
            if isinstance(node, ast.Call):
                callee = dotted(node.func)
                if not callee or "." in callee:
                    continue
                target_mod = mod.dotted
                name = callee
                if name not in cached_by_mod.get(target_mod, ()):  # local?
                    imp = mod.imports.get(name)
                    if imp is None or imp[1] not in cached_by_mod.get(
                            imp[0], ()):
                        continue
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, _UNHASHABLE):
                        yield Finding(
                            RULE, mod.relpath, arg.lineno, arg.col_offset,
                            f"unhashable literal passed to lru_cache'd "
                            f"`{name}` — raises TypeError at call time; "
                            "use a tuple")
