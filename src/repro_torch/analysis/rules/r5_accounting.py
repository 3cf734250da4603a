"""R5 — accounting hygiene.

Two bug classes, both shipped and fixed in the JAX package:

* **Quadratic FIFO drains**: ``list.pop(0)`` shifts the whole list, O(n)
  per pop and O(n^2) per drain. Service queues and the async-decode FIFO
  are deques; any ``.pop(0)`` / ``.insert(0, _)`` reintroduces the class.
* **Eager counter reads**: the executors queue device scalars
  (``_pending_counts``) and convert them only at the sanctioned flush
  sites (``_flush_counts`` / ``_consume_count`` / ``_consume_frontier``,
  plus the supervisor's ``_flush_health`` telemetry interval), so the
  ingest path never blocks on a device->host read for telemetry. A
  ``float(...now)`` or ``qrounds.item()`` anywhere else waits for the
  card to drain its queue behind a counter; the engine keeps a host clock
  mirror (``host_now``) for exactly this.

Flagged, project-wide:

* ``x.pop(0)`` and ``x.insert(0, ...)``
* ``float()`` / ``int()`` / ``bool()`` / ``np.asarray`` / ``np.array`` /
  ``np.float32`` / ``np.float64``, ``.item()`` and ``.cpu()`` over an
  expression containing a ``.now`` attribute read, unless the expression
  routes through ``device_get`` (the port's explicit, sanctioned sync) or
  the enclosing function is a sanctioned flush site
* the same conversions of a name matching ``*rounds`` / ``*counts``
  outside the sanctioned flush sites
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..analyzer import Finding, Module, Project, dotted

RULE = "R5"
TITLE = "accounting hygiene (FIFO drains, eager device-scalar reads)"

#: `_flush_health` is the supervisor's per-interval telemetry flush
#: (streaming/supervisor.py): like the executor flush sites it reads
#: counters between dispatches, never on the hot path
_SANCTIONED_FNS = ("_flush_counts", "_consume_count", "_consume_frontier",
                   "_flush_health")
_COUNTER_NAME_RE = re.compile(r"(rounds|counts)$")
_CONVERTERS = ("float", "int", "bool", "np.asarray", "np.array",
               "np.float32", "np.float64", "numpy.asarray")
_METHOD_CONVERTERS = ("item", "cpu")


def _contains_now_attr(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "now"
               for n in ast.walk(node))


def _contains_explicit_sync(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = dotted(n.func).rsplit(".", 1)[-1]
            if f in ("device_get", "synchronize"):
                return True
    return False


def _enclosing_fn(mod: Module, node: ast.AST) -> Optional[str]:
    """Innermost function qualname containing the node's line (the func
    index spans are enough: rules don't need a parent map)."""
    best, best_span = None, None
    for qual, fn in mod.funcs.items():
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= node.lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = qual, span
    return best


def _converted(node: ast.Call):
    """(converter name, converted expression) of a conversion call, or
    None."""
    conv = dotted(node.func)
    if conv in _CONVERTERS and node.args:
        return conv, node.args[0]
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _METHOD_CONVERTERS and not node.args):
        return f".{node.func.attr}", node.func.value
    return None


def check(project: Project) -> Iterator[Finding]:
    for mod in project:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # -- FIFO drains ----------------------------------------------
            if isinstance(func, ast.Attribute):
                if (func.attr == "pop" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and node.args[0].value == 0):
                    yield Finding(
                        RULE, mod.relpath, node.lineno, node.col_offset,
                        "`pop(0)` is O(n) per pop (O(n^2) per drain) — "
                        "use collections.deque.popleft()")
                    continue
                if (func.attr == "insert" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and node.args[0].value == 0):
                    yield Finding(
                        RULE, mod.relpath, node.lineno, node.col_offset,
                        "`insert(0, ...)` shifts the whole list — use "
                        "collections.deque.appendleft()")
                    continue
            # -- eager device-scalar reads --------------------------------
            conv = _converted(node)
            if conv is None:
                continue
            name, arg = conv
            fn_name = (_enclosing_fn(mod, node) or "").rsplit(".", 1)[-1]
            if fn_name in _SANCTIONED_FNS:
                continue
            if _contains_now_attr(arg) and not _contains_explicit_sync(arg):
                yield Finding(
                    RULE, mod.relpath, node.lineno, node.col_offset,
                    f"eager `{name}()` of the device stream clock waits for "
                    "the card — read the host mirror (`host_now`) or go "
                    "through device_get at a flush site")
            elif isinstance(arg, ast.Name) and _COUNTER_NAME_RE.search(arg.id):
                yield Finding(
                    RULE, mod.relpath, node.lineno, node.col_offset,
                    f"eager counter read `{name}({arg.id})` outside the "
                    "sanctioned flush sites — queue it via _account and "
                    "convert in _flush_counts")
