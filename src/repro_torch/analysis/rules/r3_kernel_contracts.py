"""R3 — kernel contracts (scope: ``kernels/``).

Invariant: a launch takes its tile and launch sizes from a named
module-level table value (such as ``_TILE_BM``, the tile table of
``kernels/maxmin/maxmin.py`` that its CUDA source's ``dispatch`` reads),
not a literal written at the call, so every wrapper and its CUDA source
agree on one table and a retune edits one line. And a bound C entry that
takes device memory is launched only through ``call_on``
(``kernels/build.py``), which hands it the raw handle of the current
stream on the tensor's device and makes that device current: a direct
call launches on whatever stream and device happen to be current, out of
order with the PyTorch work around it.

The JAX package's second half (``BlockSpec`` index maps must be pure
functions of the grid indices) has no CUDA counterpart: a CUDA kernel
computes its block offsets from ``blockIdx`` in the source, and the
nearest Python-side contract is the launch's stream and device, checked
here instead.

Flagged, in files under ``kernels/``:

* an int literal >= 8 among the launch arguments of ``call_on(t, fn,
  ...)`` or of a direct call of a bound entry (``bind(...)(...)``, or a
  local name bound to ``bind(...)``): small structural values (a flag, a
  count below a tile) stay legal
* a ``.data_ptr()`` handed to any call other than ``call_on``: a launch
  on device memory that bypasses the stream and device ``call_on`` sets
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from ..analyzer import Finding, Project, dotted, scan_region

RULE = "R3"
TITLE = "kernel contracts (literal launch sizes, launches outside call_on)"

_MIN_TILE_LITERAL = 8


def _bound_names(fn: ast.AST) -> Set[str]:
    """Local names assigned the result of ``bind(...)``."""
    out: Set[str] = set()
    for n in scan_region(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                and dotted(n.value.func).rsplit(".", 1)[-1] == "bind"):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return out


def _launch_args(call: ast.Call, bound: Set[str]) -> List[ast.AST]:
    """The launch arguments of a call of a bound entry, [] otherwise."""
    callee = dotted(call.func).rsplit(".", 1)[-1]
    if callee == "call_on":
        return list(call.args[2:])
    direct = (isinstance(call.func, ast.Call)
              and dotted(call.func.func).rsplit(".", 1)[-1] == "bind")
    if direct or (isinstance(call.func, ast.Name) and call.func.id in bound):
        return list(call.args)
    return []


def _is_data_ptr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "data_ptr")


def check(project: Project) -> Iterator[Finding]:
    for mod in project:
        if "kernels/" not in mod.relpath:
            continue
        scopes = [mod.tree] + list(mod.funcs.values())
        for scope in scopes:
            bound = _bound_names(scope)
            for node in scan_region(scope):
                if not isinstance(node, ast.Call):
                    continue
                for arg in _launch_args(node, bound):
                    if (isinstance(arg, ast.Constant) and isinstance(arg.value, int)
                            and not isinstance(arg.value, bool)
                            and arg.value >= _MIN_TILE_LITERAL):
                        yield Finding(
                            RULE, mod.relpath, arg.lineno, arg.col_offset,
                            f"literal launch size {arg.value} passed to a bound "
                            "C entry: take it from a named module-level table "
                            "value")
                if dotted(node.func).rsplit(".", 1)[-1] == "call_on":
                    continue
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if _is_data_ptr(arg):
                        yield Finding(
                            RULE, mod.relpath, arg.lineno, arg.col_offset,
                            "device pointer handed to a call outside `call_on`: "
                            "launch bound C entries through call_on, which sets "
                            "the tensor's device and stream")
